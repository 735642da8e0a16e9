#!/usr/bin/env python3
#
# Drives the PyTorch port (spark_rapids_ml_tpu_torch) on one NVIDIA card:
#
#   1. card and setup: the card's name and power limit, TF32 off, the CUDA
#      kernels built from csrc/*.cu with nvcc;
#   2. every kernel against its plain PyTorch version on the card, at its
#      main path's tile (KMeans: 32768 x 3000 rows against k = 1000 centers;
#      kNN: 4096 queries against a 16,384-item block, d = 3000) and at
#      ragged shapes (among them IVFPQ's codebook tile, d = 375 and k = 256),
#      in every variant (f32, f32 fast, f64, f64 fast; fast =
#      bf16 products with float32 sums): integer-valued data must agree
#      exactly (ties included), Gaussian data to the stated tolerances, and
#      the accumulation must be bitwise deterministic; for assign_argmin also
#      a tie across a boundary of its center tiles (the first copy of a
#      repeated center must win) and batch independence (rows sent in
#      batches of 1 to 16,960 equal the same rows of the 32768-row tile bit
#      for bit); for d2_block also every rung of the serving ladder (256 to
#      8192 rows), batch independence (batches of 1 to 8192 rows equal the
#      same rows of one 8192-row call bit for bit) and a NaN query row in
#      the top-k merge on the card (the CPU's indices); the float64 forms
#      (not fast) held to the float64 summation bound (f64_bound) on
#      Gaussian data, and their SASS checked for DMMA instructions; for
#      assign_accumulate also skewed assignments (every row on one center,
#      a Zipf(1.1) law over the centers, and edges: empty centers, zero
#      weights, assignments outside [0, k)), past the counting sort's
#      centers too; then each kernel timed against its plain version and
#      one PyTorch call, with its build figures (ptxas registers, spills,
#      static and dynamic shared memory), its `fast` staging timed apart
#      from its tiles, and assign_accumulate's passes (preparation, sums
#      with their rate, fold) timed apart, on the card alone too
#      (device_ms), on the nearest-center and the skewed assignments;
#   3. the KMeans path at full width: KMeans(k=1000) fit on 1,000,000 x
#      3,000 float32 rows through the public API, transform of every row,
#      save and load, and a fit with the default k-means|| seeding, with the
#      launch counters showing that both of its kernels ran; plus the whole
#      path on a small input held against the plain PyTorch path on the CPU;
#   4. the exact kNN path at full width: NearestNeighbors(k=64) fit on the
#      same 1,000,000 rows and kneighbors of the first 4096 of them through
#      the public API, with the launch counter showing that every item block
#      went through the d2-block kernel; the first neighbor of every query is
#      itself; the kernel route against the plain route on the same resident
#      rows; an integer-data run with duplicated rows across an item-block
#      boundary that must agree exactly (lower index first); and
#      exactNearestNeighborsJoin;
#   5. the serving plane at full width: the phase-3 KMeansModel loaded twice
#      (float32 and bf16 scoring) and NearestNeighbors(k=64) over the same
#      1,000,000 rows loaded for bf16 scoring, in one ModelRegistry with the
#      default config (prewarm on); 4 client threads send each model 6
#      requests of 1 to 4096 rows through one ScoringEngine. Every response
#      must equal the same request served alone bit for bit; the float32
#      KMeans answers must equal KMeansModel.transform; every kNN query must
#      find itself first; the launch counter must show 62 bf16 d2-block
#      launches per dispatched kNN bucket and no float32 one; the bf16 top-k
#      against its plain version on the resident items; an integer-data bf16
#      run across item blocks must agree exactly;
#   6. the float64 route (float32_inputs=False) at full width, on the same
#      rows as float64 (24 GB): KMeans(k=1000) fit, transform and save/load,
#      held against the same fit through the plain versions on the card
#      (same n_iter_, centers and inertia to 1e-9), with only the f64 forms
#      of assign_argmin and assign_accumulate launched; one Lloyd iteration
#      timed through the kernels and plain; NearestNeighbors(k=64)
#      kneighbors of 4096 queries (62 d2_block/f64 launches), the kernel
#      route against the plain one within the float64 bound; and one
#      ModelRegistry serving the float64 KMeansModel as float64 and as bf16
#      (assign_argmin/f64-fast) and the kNN model as float64, gated on
#      coalesced = solo bit for bit;
#   7. PCA and LinearRegression, which reach no kernel of their own (cuBLAS
#      and cuSOLVER through torch): 7a on the float32 rows, before they are
#      dropped, with labels y = X·β + ε from a seed: PCA(k=3) and
#      BASELINE.md's three LinearRegression configurations (OLS; CD with
#      regParam 1e-5, elasticNetParam 0.5, tol 1e-30, maxIter 10, n_iter_
#      10; ridge with regParam 1e-5) through the public API: fit, transform
#      of the first 200,000 rows (cut from every row; the first 4096 within the float32
#      bound of X @ W), save
#      and load (bit for bit), bf16 fits of PCA and OLS held to the float32
#      fits at tests/test_precision.py's bounds, the fit's parts timed on
#      resident rows (placement, statistics pass, eigh, solves, ms per CD
#      sweep) with each solve held against the CPU's on the same
#      statistics, the whole slice on a small input against the CPU (a NaN
#      row raises SolverDivergedError, all-constant features give NaN
#      coefficients), and one ModelRegistry serving the PCA and the OLS model
#      (coalesced = solo = transform, bit for bit); 7b on the float64 rows,
#      after phase 6: PCA(k=3) and OLS with float32_inputs=False, 7a's
#      float32 results held to them within Weyl, Davis-Kahan and normwise
#      solve bounds (PERF.md section 4), and a NaN row in float64;
#   8. LogisticRegression, which reaches no kernel of its own (cuBLAS
#      products through torch; the GLM quasi-Newton and OWL-QN loops on the
#      host): 8a on the float32 rows, before they are dropped, with labels
#      argmax([0, X·β + 0.5·ε]) from a seed: BASELINE.md's row
#      (maxIter=200, tol=1e-30, regParam=1e-5), the same fit with bf16
#      products, an elastic net (elasticNetParam=0.5, OWL-QN) and a
#      multinomial fit (k = 4), the last two at maxIter=50, through the
#      public API: the four solver branches on a small float64 input
#      against the CPU, a NaN row raising SolverDivergedError, transform of
#      the first 200,000 rows (cut from every row; the first 4096 probabilities within the float32 bound of
#      float64, the prediction column their threshold / argmax, rows summing
#      to 1), save and load (bit for bit), the bf16 objective and
#      coefficients against float32, the elastic net's exact zeros, centered
#      multinomial intercepts, no kernel launched; the loops on resident rows
#      (ms per iteration, host reads per iteration equal to the card's sync
#      count, one X·b + Xᵀ·r pair against its bound); one ModelRegistry
#      serving the binomial and the multinomial model (coalesced = solo =
#      transform, bit for bit); 8b on the float64 rows, after 7b: the
#      BASELINE fit with float32_inputs=False, 8a's float32 objective and
#      coefficients held to it within the bounds of PERF.md section 4;
#   9. RandomForestClassifier and RandomForestRegressor, which reach no
#      kernel of their own (plain torch ops: binning, int64 histograms, the
#      gather descent), on the float32 rows after 8a, before they are
#      dropped: 9a on a small input (20000 x 40, 4 trees of depth 6, 32
#      bins, bootstrap on, featureSubsetStrategy auto, float32 and float64):
#      a 3-class classifier under gini and entropy and a regressor on
#      integer labels, the card's gini and variance forests equal to the
#      CPU's bit for bit, an entropy forest parting only at near-tied gains,
#      every fit twice on the card bit for bit, binning of edge values, ±inf
#      and NaN equal, fault C3's row at probability [0, 1]; 9b and 9c,
#      BASELINE.md's rows at full width, their tree counts halved: the
#      classifier {numTrees=25 (of 50), maxDepth=13, maxBins=128} on labels
#      argmax([0, X·β + 0.5·ε]) and the regressor {numTrees=15 (of 30),
#      maxDepth=6, maxBins=128} on
#      phase 7's labels, each fit (quantile sketch, binning, s per tree),
#      transform of the first 200,000 rows (cut from every row), save and load, a 2-tree refit equal to trees
#      0-1 bit for bit (ms per level and per histogram pass by depth), the
#      first 4096 rows equal to the CPU's descent bit for bit, probabilities
#      summing to 1 within 1e-6 with the prediction their argmax, training
#      accuracy above the majority rate and R² above 0 on the first 100k
#      rows; 9d, one ModelRegistry serving both forests (coalesced = solo =
#      transform, bit for bit); the launch counters unmoved;
#  10. the multi-fit engine (tuning.py, core.py's fitMultiple half), on the
#      float32 rows after phase 9, before they are dropped: 10a
#      CrossValidator over LogisticRegression(maxIter=30, tol=1e-12),
#      regParam = logspace(-6, -3, 4), 3 folds, accuracy, on phase 8's
#      labels: 1 ingest, 1 placement, 12 batched solves and 1 refit by the
#      counters, fold 0's batched models equal the single fits with the fold
#      mask as a weight column bit for bit, the grid's host reads on
#      resident rows equal the longest single fit's and the card's sync
#      count; 10b CrossValidator over LinearRegression(tol=1e-30,
#      maxIter=2, cut from 10), regParam {1e-5, 1e-3} x elasticNetParam {0, 0.5}, on
#      phase 7's y: a normal-equation and a CD group per fold, batched CD
#      equal to sequential CD bit for bit; 10c TrainValidationSplit over an
#      OWL-QN pair (regParam 1e-2, elasticNetParam {0.5, 1.0}): the single
#      fits' zeros; 10d KMeans(maxIter=3).fitMultiple over k {500, 1000}:
#      one placement, models and transforms equal to the single fits, B1 and
#      B2 counted in the run fit_multiple; 10e on 9a's input, a
#      CrossValidator over the forest (the per-model fallback) equal on the
#      card and the CPU, and a Pipeline saved and loaded; the timings (CV
#      wall, placement, s per fold, ms per batched GLM iteration against S x
#      the single fit's, ms per batched CD sweep against one);
#  11. ApproximateNearestNeighbors on the float32 rows after phase 10:
#      IVFFlat {nlist 256, nprobe 16}, IVFPQ {the same, M = 8, n_bits = 8,
#      refine_ratio 4} and CAGRA {graph degree 64, intermediate 128,
#      build_algo ivf_pq, itopk 64} (benchmark/bench_approximate_nearest_
#      neighbors.py's values; CAGRA's NN-descent cut from 3 rounds to 1, its
#      clustered seeding from 8 repetitions to 2),
#      k = 64 for the first 4096 rows
#      through the public API: each build's seconds split into its parts
#      (seeding, Lloyd, layout, PQ training, encoding; CAGRA's seeding reps
#      and each descent round with its n_new), peak memory, search seconds
#      and queries/s, recall@64 against phase 4's exact ids and the found
#      k-th neighbour's true distance over the exact k-th; IVFFlat must find
#      every query itself first at recall >= 0.85; every id a row or -1,
#      distances finite and ascending; B1 f32 and f32-fast, B2 f32-fast and
#      B3 f32 counted, no float64 form;
#  12. DBSCAN and UMAP at benchmark/benchmark_runner.py's protocol sizes,
#      nothing cut, on blobs made from a seed as make_blobs makes them:
#      12a DBSCAN on 40000 x 64 rows (20 centres, eps 12, min_samples 5,
#      max_mbytes_per_batch 512) through the public API, each pass timed
#      (core mask, components with their rounds, border), ARI against the
#      generating labels >= 0.99, no kernel launched, and on 4000 integer
#      rows the card's labels and core indices equal to the CPU's exactly
#      for euclidean, cosine and precomputed at two tile budgets; 12b UMAP
#      at 20000 and 100000 x 64 rows (10 centres, n_neighbors 15, n_epochs
#      200, random_state 42): fit (kNN graph, smooth kNN, fuzzy set,
#      spectral init, SGD with its ms an epoch) and the transform of every
#      row timed, trustworthiness of the first 2000 rows >= 0.90, at 20000
#      rows a second fit equal bit for bit (at 100000 cut for the script's
#      time), d2_block/f32 launched by the fit and the
#      transform as the tiles say and no other form, the graph through B3
#      against the plain route on the same resident rows, and at 20000 rows
#      the graph, the fuzzy weights and a 5-epoch layout against the CPU;
#      phase 2 also checks d2_block/f32 at d = 64 (exact on integers) and
#      times it against torch.addmm;
#  13. the out-of-core fits (memory admission, ops/streaming.py), on the
#      float32 rows after phase 11, every earlier tensor released from the
#      card first: 13a the double-buffered pipeline (two page-locked host
#      buffers, the copies on a side stream) at the chunk the admission
#      sizes under an 8 GiB budget: every streamed chunk equal to one
#      place_rows of the rows bit for bit, a pass's GB/s against the
#      host-to-page-locked and page-locked-to-card rates of one chunk alone,
#      and ingest.overlap_fraction > 0 on a pass whose caller works longer
#      on a chunk than a copy takes; 13b demotion by that budget: KMeans
#      (k=1000, random init, 2 iterations, cut from 3) in high and fast, PCA(k=3), OLS
#      and LogisticRegression (regParam 1e-5, 1 iteration, cut from 10) streamed, each
#      held to its resident fit (KMeans: the first iteration's assignments
#      equal, the first update's centers within 1e-5 of the largest
#      |center| (later ones may part at near-tied rows: reported), final
#      inertia rtol 1e-5, B1 and B2 launched exactly as the chunks' tiles
#      imply; PCA and OLS: phase 7a's fits within its Weyl, Davis-Kahan and
#      normwise bounds, doubled; logistic: objective rtol 1e-5, coefficients
#      1e-3 normwise), fit.demotions once a fit, s a pass and a fit; 13c an
#      allocator capped at 10 GiB (set_per_process_memory_fraction, no
#      budget set): KMeans's 12 GB placement raises torch.OutOfMemoryError,
#      caught and retried once streamed, equal to 13b's model bit for bit,
#      and a RandomForestClassifier's raises HbmBudgetError naming
#      placement.X; 13d a NaN in the third chunk of a streamed fit with
#      validate_ingest raises IngestValidationError naming the column and
#      the global row;
#  14. sparse input (CSR through the public entry points), after phase 12,
#      at the reference's tests_large shape, 10,000,000 x 2200 at density
#      0.001, float32, from this script's O(nnz) generator (random_csr,
#      benchmark/gen_data.py's recipe): 14a LogisticRegression (regParam
#      1e-6, standardization, maxIter 60) on the padded-ELL layout with its
#      conversion, placement and solve timed apart, accuracy on the first
#      200,000 rows and the cosine to the generating coefficients >= 0.9, a
#      second fit bit for bit, a 4-point regParam grid equal to its single
#      fits bit for bit, a 100,000-row slice on the card against the CPU;
#      14b LinearRegression (OLS, ridge, CD elastic net) with its statistics
#      pass and solve apart, OLS bit for bit twice, a 500,000-row slice
#      against the densified dense fit; 14c both streamed under a 1 GiB
#      budget and held to their resident fits; 14d a 3 x 4 CrossValidator
#      on 250,000 rows (cut from 1,000,000) converting and placing once; 14e NearestNeighbors
#      (k=64) over 500,000 x 2200 CSR items (cut from 1,000,000) at density 0.01 for 4096 dense
#      queries, every item tile through B3 (d2_block/f32), the kernel route
#      equal to the plain route; 14f a weighted k-means|| seeding twice, bit
#      for bit;
#  15. serving overload and the ops plane, right after phase 5, with phase
#      3's KMeansModel (k = 1000, d = 3000): 15a the serving saturation
#      protocol (benchmark/bench_saturation.py's run_saturation_bench, its
#      parameters and its five gates unchanged: 32-row requests, 128-row
#      batches, a 2 s plateau of 4 closed-loop clients, a 4 s open-loop
#      burst at 2.5 x the plateau declared by a chaos `burst` entry, a
#      recovery, every dispatch delayed 20 ms by a chaos `delay:stage=serve`
#      entry; serve_degraded_dtype "bf16", hold 0.4 s, 0.25 s x 24 windows):
#      zero over-deadline dispatches, the burst p99 within the deadline plus
#      the SLO threshold, burst goodput >= 0.3 and recovery goodput >= 0.6 of
#      the plateau, the ladder engaged with every transition audited, and
#      assign_argmin/f32-fast launched by the degraded rung during the
#      burst; 15b the degrade rung forced: KMeans answers equal a
#      serve_dtype="bf16" registry's bit for bit with assign_argmin/f32-fast
#      launched once per dispatched tile, a float64 NearestNeighbors(k=64)
#      over 131,072 x 3000 float64 items served on its float64 rung
#      (d2_block/f64) and its degraded rung (d2_block/f64-fast, one launch
#      per item block and dispatch), equal to bf16 serving bit for bit;
#      both degraded rungs held against a plain reference of bf16 rounding
#      with float64 sums (KMeans on every drill row, kNN on every 16th
#      query over all items): assignments, neighbors and distances equal
#      but for ties within the bound of float32 sums, with planted errors
#      that the check must catch; the kNN recall@64 against the float64
#      rung >= 0.98 (measured, see the floor's comment); shed and throttle refused
#      typed with their levels; 15c the ops plane: /metrics scraped once on
#      an ephemeral port (15a's serve.* counters), /healthz, report()'s
#      serving tenants and backpressure decisions, an SRML_NUMCHECK=1 sweep
#      of a degraded response with no trip;
#  16. recovery (checkpoint.py, core.retryable_stage, the solver
#      checkpoints), right after phase 8a, on the protocol rows: 16a
#      KMeans(k = 1000, random init, maxIter 6, tol 0) in `fast` and `high`
#      at a checkpoint cadence of 2, each mode's unchecked, checkpointed and
#      `fail:stage=solve`-faulted fits in one device_dataset_scope, equal
#      bit for bit, the faulted one with fit.retries 1 and
#      checkpoint.restores 1 and the unchecked fit's B1/B2 launches (no
#      iteration ran twice); 16b a resident `high` fit under
#      `oom:stage=solve:round=4`: the fault at the iteration-4 boundary, the
#      streamed retry, in 13b's chunks of 300,000 rows, resuming that
#      checkpoint (memory.oom_caught, fit.demotions and checkpoint.restores
#      1; B1/B2 launches of 4 resident and 3 streamed passes), bit for bit
#      with 16a's resident fit; 16c LogisticRegression, the GLM quasi-Newton {regParam 1e-5,
#      maxIter 30, tol 1e-30} and OWL-QN {regParam 1e-4, elasticNetParam
#      0.5, maxIter 30}, at a cadence of 10 with the fault at the
#      iteration-20 boundary: resumed = checkpointed = unchecked bit for
#      bit, and the host reads per iteration with and without the cadence;
#      16d PCA(k=3) and OLS under `fail:stage=solve`: the retry reuses the
#      retained statistics (checkpoint.stats_reuses 1, one statistics pass),
#      equal bit for bit, the retry's seconds against phase 7a's statistics
#      pass; 16e a streamed GLM (6 iterations at a cadence of 3, the fault
#      at 3) and OLS on 200,000 rows under a 1 GiB budget, each resumed fit
#      equal to its uninterrupted streamed fit bit for bit;
#  17. the multi-tenant fit scheduler (scheduler/, memory.admit_fit's job
#      branch, the solvers' preemption points), right after phase 16, on
#      the protocol rows, held to phase 16's unchecked fits: 17a
#      benchmark/bench_scheduler.py's contention lane at full width, 4
#      tenants: the even ones each submit one big priority-0 job (16a's
#      `fast` KMeans at a cadence of 2; the lane's maxIter 120 at a cadence
#      of 3 cut to 6), the odd ones each a burst of 3 small priority-10
#      KMeans(k = 100, maxIter 10, seed 3, random init) on a view of the
#      first 100,000 rows, under a budget of a big job and half a small one (the lane's
#      sizing, from the port's resident estimates), the bursts submitted
#      right after the first big job's admission: no admission decision
#      over budget, at least one preemption and as many resumes, every job
#      completed and equal to its uninterrupted fit bit for bit (the big
#      ones to 16a's unchecked `fast` fit), B1/B2 launches by form equal to
#      the uninterrupted passes of the 8 jobs (no iteration twice), the
#      ledger back at 0; wall s, rows/s, utilization, queue waits per
#      tenant and of the high-priority jobs, the preemption's margin; 17b
#      16c's GLM at a cadence of 10, preempted by a priority-10 GLM on
#      100,000 rows and resumed equal to 16c's unchecked fit bit for bit;
#      17c 16a's `high` fit with sched_max_preemptions 1, asked to yield
#      after its first checkpoint: demoted, resumed streamed in 16b's
#      chunks, its launches those of the resident passes before and the
#      streamed passes after, equal to 16a's unchecked `high` fit bit for
#      bit; 17d a RandomForestClassifier over its budget refused at submit
#      naming placement.X, the ops report's tenants with byte-seconds, and
#      every audit record under its job's tenant. The phase fails if the
#      ledger holds a claim when it starts (naming its owners), or if the
#      card keeps over 1 GiB more reserved after it than before;
#  18. multi-process fits (after phases 9-14; the order of the phases run
#      after 17 is 9, 10, 11, 13, 12, 14, 18, 19, 17e, 6, 7b, 8b):
#      two ranks, each this script started afresh with `--mp-worker`,
#      share the card over a gloo process group and meet through a
#      FileRendezvous; each makes only its rows of the protocol data (rank
#      0: [0, 589,824), rank 1: [589,824, 1,000,000), the generator's chunk
#      boundaries) under hbm_budget_bytes half the card, and fits under
#      TpuContext: KMeans(k = 1000, random init, maxIter 3) `high` and
#      `fast`, PCA(k = 3), OLS, LogisticRegression at 8a's row, and exact
#      kNN of phase 4's 4096 queries (2048 a rank), k = 64. Gated on every
#      rank's models equal to rank 0's bit for bit; KMeans equal bit for
#      bit to one process summing the same row blocks in rank order, and
#      within 1e-4 of the plain one-process fit's inertia with at least
#      0.999 of every 16th row's assignment equal; PCA, OLS and the GLM held
#      to 7a and 8a by 13b's bounds; the kNN ids equal to phase 4's and the
#      distances within 1e-5; B1 (f32, f32-fast), B2 (f32, f32-fast) and
#      B3 f32 launched on both ranks; 18b, a one-rank NCCL group opened by
#      the same code, its all-gather on the card equal to its input. Then
#      in the same ranks: 18c RandomForestClassifier at 9b's row with 8
#      trees (4 a rank) on every row, the ranks' forests equal, tree 0 of
#      each rank regrown on one process (`ops.trees.grow_tree` on the
#      rank's rows, the ranks' edges, a draw over the larger block) equal
#      to the rank's, training accuracy on 100,000 fixed rows >= 0.85; 18d
#      12a's DBSCAN, rows split 60/40, the labels equal to 12a's; 18e 12b's
#      UMAP at 20000 rows (cut from 100000) split 60/40, the embedding equal to 12b's bit for
#      bit, each rank's transform to the one-process transform of its rows;
#      18f phase 11's indexes over each rank's rows (CAGRA over the first
#      65,536 rows of each, a cut) and phase 4's queries: IVFFlat over
#      every list gives phase 4's id sets (64th/65th near-ties counted),
#      IVFFlat and IVFPQ at nprobe 16 within 0.02 of phase 11's recall,
#      CAGRA's ids valid and its recall printed; 18g phase 14's sparse rows
#      split 60/40: 14a's LogisticRegression within 1e-6 of its objective,
#      OLS within 1e-4 (normwise) of 14b's, the sparse kNN's ids equal to
#      14e's; 18h 10a's CrossValidator (LogisticRegression, maxIter 30,
#      regParam logspace(-6, -3, 4), 3 folds, accuracy) over each rank's
#      first 90,000 / 60,000 rows (150,000 in all, a cut): one ingest and
#      one layout a rank, every rank's metrics, winner and refit equal, and
#      against the parent's one-process sweep over the same rows in rank
#      order with the ranks' folds the same winner and every avgMetric within
#      0.01, the gathered
#      bytes and seconds of each fold printed. Rank 0 then opens 18b's
#      one-rank NCCL group and 18b' reforms it to generation 1 with no dead
#      rank (the communicator aborted, a new one opened, its all-gather equal
#      to its input). Last, 18i: both ranks fit KMeans(k = 1000, random
#      init, maxIter 6) `high` on their rows, checkpointed every 2
#      iterations, with one rank loss allowed; rank 0, the host of the
#      group's store, is SIGKILLed by the parent once its iteration-2
#      checkpoint has landed; the survivor must be alone at generation 1
#      with fit.recoveries, recovery.epochs, recovery.rank_losses and
#      rendezvous.reforms at 1 and a checkpoint restored, its centers equal
#      bit for bit to the parent's one-process Lloyd run over its rows from
#      the centers it resumed from. 18j, the fleet plane over the two ranks
#      (telemetry on, `fleet_ops_round_seconds` 0, so every top-level fit
#      and sweep from 18 to 18h runs an ops round on its trace round): after
#      18h each rank saves its last cluster view and its ops snapshot; both
#      views name ranks 0 and 1 and miss none, are healthy, and have equal
#      counters, each merging at least two rendezvous rounds an ops round;
#      each rank ran an ops round on every top-level fit and sweep, none
#      failed; the parent's offline merge of the snapshots
#      (`fleet.read_rank_snapshots`) names both ranks, none stale; the
#      seconds the trace and ops rounds add to each rank
#      (rendezvous.allgather_s) are printed, and the survivor's failed ops
#      rounds and trace exchanges after 18i's kill. Each rank's placement,
#      collective and solve seconds and its launches are printed by
#      sub-phase;
#  19. one process driving two chips (after phase 18, on the float32 rows):
#      the visible cards when there are two or more, else two chips on card
#      0 (cuda:0 twice, as phase 18's ranks share it), num_workers=2, the
#      protocol rows in blocks [0, 500,000) and [500,000, 1M), one thread a
#      chip over the in-process group, in one device_dataset_scope:
#      KMeans(k = 1000, random init, maxIter 3) `high` and `fast`, its
#      transform split over the chips on the first 200,000 rows, exact kNN
#      of phase 4's queries (k = 64), PCA(k = 3), LogisticRegression at 8a's
#      row with maxIter 20. Gated on every chip's model equal to rank 0's;
#      KMeans equal bit for bit to one process summing the two blocks in chip
#      order from the same init; the split transform equal to one chip's; the
#      kNN ids equal to phase 4's; PCA within phase 18's bounds of 7a's; the
#      GLM within 1e-5 (objective) and 1e-3 (coefficients) of the same fit
#      on one chip; B1/B2 (f32, f32-fast) and B3 f32 launched as the chips'
#      tiles say; with an ops round due on every trace round, the fanned
#      fits run none and leave no round stamps in the fleet plane. Each
#      chip's placement, collective and solve seconds and a GLM iteration's
#      ms are printed;
#      17e. bench_scheduler.py's co-admission lane on phase 19's pool: two
#      KMeans jobs (k 8, maxIter 12, tol 0, seed 7, random init) each half
#      the pool wide over the first 262,144 protocol rows, co-admitted by
#      FitScheduler(chip_placement=True), then time-sliced (max_concurrent
#      1), and three jobs of which the third queues on chip overlap alone:
#      peak occupancy 2 chips, the co-admitted occupancy integral at least
#      1.5x the time-sliced one, every model equal bit for bit across the
#      schedules and to the job run alone, no admission over budget; the
#      rows/s of both schedules printed;
#  20. a {"kernels": [...]} line with all twelve kernel forms, the
#      nvidia-smi line, and as the last line {"ok": true, "device": {...}}.
#      The seconds of each phase are printed as it ends.
#
# Every phase raises on failure; the script prints no result then. It needs
# the repository around it and one CUDA card, and exits non-zero without
# either. Run from the repository root:
#
#     python3 chip_smoke.py
#
# The kernels are built into build/ (listed in .gitignore), and a copy of
# everything printed goes to build/chip_smoke.log.
#
import contextlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
LOG_DIR = ROOT / "build"

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over the memory rate and its operations over the rate of
# its type. float64 uses the FP64 tensor-core peak, the card's fastest rate
# for that type.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f32-fast": 989e12, "f64": 67e12, "f64-fast": 989e12}
VARIANTS = ("f32", "f32-fast", "f64", "f64-fast")

# the main path's shapes (BASELINE.md protocol: 1M x 3k float32, k = 1000)
N_ROWS, N_COLS, K = 1_000_000, 3000, 1000
TILE_ROWS = 32768  # KMeans max_samples_per_batch: one Lloyd tile
# the exact kNN lane of bench.py: 4096 queries against the same rows, k = 64
KNN_QUERIES, KNN_K = 4096, 64
# phase 11's IVFPQ codebooks: the depth of one subspace at M = 8 (375, odd)
ANN_PQ_DSUB = N_COLS // 8
# the serving traffic: client threads, requests per thread and model, and the
# request sizes they cycle through
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_SIZES = 4, 6, (1, 7, 64, 255, 1000, 4096)
# assign_argmin's batch independence: (rows, first row) slices of one
# 32768-row tile, from a single row to the Lloyd loop's ragged tail
BATCH_SLICES = ((1, 5), (7, 130), (255, 1), (4096, 12345), (16960, 15808))
# the serving bucket ladder (transform_bucket_min_rows to serve_max_batch_rows),
# and d2_block's batch independence: (rows, first row) slices of one call at
# its top rung
SERVE_RUNGS = (256, 512, 1024, 2048, 4096, 8192)
D2_BATCH_SLICES = ((1, 5), (7, 130), (255, 1), (256, 7000), (1000, 333), (2048, 4096), (4096, 2345),
                   (8192, 0))


def _variant_dtype(variant):
    return (np.float64 if variant.startswith("f64") else np.float32), variant.endswith("fast")

_log_lines = []


def say(*parts):
    line = " ".join(str(p) for p in parts)
    print(line, flush=True)
    _log_lines.append(line)


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(fn, reps=5):
    """Mean ms of one call of `fn` on the card: CUDA events around `reps`
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


_spin = {"cycles": 20_000_000}


def device_ms(fn, reps=20):
    """Mean ms of one call of `fn` on the card alone: the calls are queued
    behind a spin of the card (torch.cuda._sleep) that lasts longer than the
    host takes to enqueue them, so the events time the card's work back to
    back without the host's launch time between calls (which cuda_ms
    includes where a call's launches take the host longer than the card
    takes to run them). The reps' launches must fit the card's launch queue
    (a few hundred): past it the host waits for the spin, which no spin
    outlasts, and this raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_end = torch.cuda.Event(enable_timing=True)
    while True:
        spin_start = torch.cuda.Event(enable_timing=True)
        spin_start.record()
        torch.cuda._sleep(_spin["cycles"])
        spin_end.record()
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        spin_ms = spin_start.elapsed_time(spin_end)
        if spin_ms > host_ms:
            return start.elapsed_time(end) / reps
        if spin_ms > 2000:
            fail(f"device_ms: the host took {host_ms:.0f} ms to enqueue {reps} calls behind a "
                 f"{spin_ms:.0f} ms spin: too many launches to queue")
        _spin["cycles"] *= 2


def bound_ms(nbytes, flops, variant):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[variant]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def f64_bound(d, a, b, scale):
    """How far two float64 computations of c_sq - 2 a.b (or of any sum of
    the same d products, in any order) may lie apart: each dot product is
    within d 2^-53 ||a|| ||b|| of the exact sum (the summation bound, for
    any order of the additions), so the two -2 a.b within
    4 d 2^-53 max||a|| max||b||; and each result, up to `scale` in size,
    is rounded once more (2^-53 scale each)."""
    import torch

    norms = float(torch.linalg.vector_norm(a.double(), dim=1).max()
                  * torch.linalg.vector_norm(b.double(), dim=1).max())
    return 4 * d * 2.0 ** -53 * norms + 2.0 ** -52 * scale


# ------------------------------------------------------------ phase 1 ----


def phase_setup():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    say("torch.backends.cuda.matmul.allow_tf32 = False; torch.backends.cudnn.allow_tf32 = False")
    from spark_rapids_ml_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build()
    say(f"kernels built in {time.perf_counter() - t0:.1f} s into {_kernels.BUILD_DIR}")
    for name in _kernels.SOURCES:
        for fn, info in ptxas_table(_kernels.ptxas_report(name)).items():
            say(f"  {name}: {fn}: {info}")
    # the float64 forms must reach the FP64 tensor cores: DMMA in their SASS
    for name in ("assign_argmin", "d2_block"):
        n = sass_count(_kernels._lib_path(name), "DMMA", PTXAS_KERNELS[name]["f64"])
        if not n:
            fail(f"{name}: no DMMA instruction in the SASS of its float64 kernel")
        say(f"  {name}: {n} DMMA instructions in the SASS of its float64 kernel ({PTXAS_KERNELS[name]['f64']})")
    return smi


def sass_count(lib_path, opcode, function=None):
    """How many `opcode` instructions `cuobjdump -sass` finds in a built
    library, in the functions whose name matches `function` (all where it
    is None). Raises where the toolkit has no cuobjdump."""
    from spark_rapids_ml_tpu_torch.ops import _kernels

    tool = Path(_kernels._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        fail(f"no cuobjdump beside {_kernels._nvcc()}: the SASS cannot be checked")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    count, inside = 0, function is None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = function is None or re.search(function, m.group(1)) is not None
        elif inside and re.search(rf"\b{opcode}\b", line):
            count += 1
    return count


def ptxas_table(report):
    """{kernel function: {"registers", "spill_stores", "spill_loads",
    "smem_static"}} from nvcc's -Xptxas -v report (bytes for the last three)."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                out[fn].update(registers=int(m.group(1)), smem_static=int(smem.group(1)) if smem else 0)
    return out


# the kernel function of each variant's main pass, per kernel, as its name
# appears in nvcc's report
PTXAS_KERNELS = {
    "assign_argmin": {"f32": r"argmin_f32_tiles", "f64": r"argmin_f64_tiles",
                      "f32-fast": r"argmin_fast_tilesIf", "f64-fast": r"argmin_fast_tilesId"},
    "d2_block": {"f32": r"d2_block_f32", "f64": r"d2_block_f64",
                 "f32-fast": r"d2_block_fastIf", "f64-fast": r"d2_block_fastId"},
    "assign_accumulate": {"f32": r"accumulate_sumsIfLb0E", "f64": r"accumulate_sumsIdLb0E",
                          "f32-fast": r"accumulate_sumsIfLb1E", "f64-fast": r"accumulate_sumsIdLb1E"},
}


def kernel_ptxas(name, variant):
    """The build figures of one variant of kernel `name`: its main pass
    (both load widths for f32 and f64; for assign_accumulate, the sum and
    fold passes in both load widths and the counting sort's passes) and, for
    assign_argmin, its merge pass; a `fast` or f64 pass of assign_argmin or
    d2_block adds its dynamic shared memory (the TMA or cp.async ring)."""
    from spark_rapids_ml_tpu_torch.ops import _kernels

    dtype_code = "d" if variant.startswith("f64") else "f"
    out = {}
    if name == "assign_accumulate":
        fold = PTXAS_KERNELS[name][variant].replace("sums", "fold")
        for fn, info in ptxas_table(_kernels.ptxas_report(name)).items():
            width = "scalar" if "ELi1E" in fn else "vec"
            if re.search(PTXAS_KERNELS[name][variant], fn):
                out[f"sums_{width}"] = dict(info)
            elif re.search(fold, fn):
                out[f"fold_{width}"] = dict(info)
            else:
                m = re.search(r"accumulate_(plan|count|scatter)E", fn)
                if m:
                    out[m.group(1)] = dict(info)
        return out
    config = (_kernels._lib(name).srml_argmin_config if name == "assign_argmin"
              else _kernels._lib(name).srml_d2_config)
    for fn, info in ptxas_table(_kernels.ptxas_report(name)).items():
        if re.search(PTXAS_KERNELS[name][variant], fn):
            key = "tiles" if variant.endswith("fast") else ("tiles_vec" if "ILb1" in fn else "tiles_scalar")
            out[key] = dict(info)
            out[key]["smem_dynamic"] = {"f32": 0, "f64": config(8)}.get(variant, config(7))
        elif name == "assign_argmin" and re.search(r"argmin_mergeI" + dtype_code, fn):
            out["merge"] = dict(info)
    return out


# ------------------------------------------------------------ phase 2 ----


def _inputs(n, k, d, dtype, integer, seed, dev, tie_at=None):
    """Rows, centers and weights. With `tie_at`, centers tie_at - 9 to
    tie_at + 6 repeat one row and the first 64 rows lie on it, so the copies
    straddle the center-tile boundary at tie_at and the first copy,
    tie_at - 9, must win those rows."""
    g, tdt = _device_rng(seed, dev, dtype)
    if integer:  # exact in bf16/f32/f64, duplicated centers force ties
        X = _randint(g, -4, 5, (n, d), tdt)
        C = _randint(g, -4, 5, (k, d), tdt)
        C[k // 2:k // 2 + 3] = C[0]
        C[k - 1] = C[1]
        w = _randint(g, 1, 4, (n,), tdt)
    else:
        X = _randn(g, (n, d), tdt)
        C = _randn(g, (k, d), tdt)
        w = _uniform(g, 0.5, 2.0, (n,), tdt)
    if k >= 64:  # a trailing block repeating one row, as k-means|| pads its candidates
        C[k - k // 8:k - 1] = C[k - k // 8 - 1]
    if tie_at is not None:
        C[tie_at - 8:tie_at + 7] = C[tie_at - 9]
        X[:64] = C[tie_at - 9]
        if not integer:
            X[:64] += 0.01 * _randn(g, (64, d), tdt)
    return X, C, w


# The kernel checks' inputs are drawn on the device from a seeded generator
# (Philox on the card): the same values on every run, and no host time (the
# host's generator took most of phase 2's seconds at these sizes). Normal
# values are drawn in float64 and rounded, as before.
def _device_rng(seed, dev, dtype):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    return g, (torch.float32 if np.dtype(dtype) == np.float32 else torch.float64)


def _randint(g, lo, hi, shape, tdt):
    import torch

    return torch.randint(lo, hi, shape, generator=g, device=g.device).to(tdt)


def _randn(g, shape, tdt):
    import torch

    return torch.randn(shape, generator=g, device=g.device, dtype=torch.float64).to(tdt)


def _uniform(g, lo, hi, shape, tdt):
    import torch

    return (lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device, dtype=torch.float64)).to(tdt)


def check_kernels(n, k, d, dtype, fast, integer, seed, dev, case="", tie_at=None):
    """One shape and variant, kernel against plain version; returns
    (max |mind err|, max |sums err|). `case` names the shape in the log;
    `tie_at` builds a tie across that center-tile boundary (_inputs)."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    x, c, w = _inputs(n, k, d, dtype, integer, seed, dev, tie_at)
    # first index of each center's value: a repeated center must lose every
    # tie to its first copy, on either kind of data
    _, first, inverse = np.unique(c.cpu().numpy(), axis=0, return_index=True, return_inverse=True)
    first_copy = torch.from_numpy(first[inverse.reshape(-1)]).to(dev)
    c_sq = D._c_sq(c)
    m1, b1 = _kernels.assign_argmin(x, c, c_sq, fast=fast)
    torch.cuda.synchronize()
    m0, b0 = D.assign_argmin_plain(x, c, c_sq, fast)
    s1, n1 = _kernels.assign_accumulate(x, w, b0, k, fast=fast)
    s2, n2 = _kernels.assign_accumulate(x, w, b0, k, fast=fast)
    torch.cuda.synchronize()
    s0, n0 = D.accumulate_plain(x, w, b0, k, fast)
    tag = f"{n}x{d} k={k} {np.dtype(dtype).name}{' fast' if fast else ''} {'integer' if integer else 'gaussian'}"
    if case:
        tag += f" [{case}]"
    if not (torch.equal(s1, s2) and torch.equal(n1, n2)):
        fail(f"assign_accumulate is not deterministic: {tag}")
    if not torch.equal(first_copy[b1.long()], b1.long()):
        fail(f"assign_argmin picked a later copy of a repeated center: {tag}")
    if tie_at is not None:
        for route, b in (("kernel", b1), ("plain", b0)):
            if not bool((b[:64] == tie_at - 9).all()):
                fail(f"assign_argmin ({route}) did not give the tied rows the first copy "
                     f"{tie_at - 9}: {sorted(set(b[:64].tolist()))}: {tag}")
    mind_err = (m1 - m0).abs().max().item()
    sums_err = (s1 - s0).abs().max().item()
    if integer:
        if not torch.equal(b1, b0):
            fail(f"assign_argmin best differs on integer data ({int((b1 != b0).sum())} rows): {tag}")
        if not torch.equal(m1, m0):
            fail(f"assign_argmin mind differs on integer data (max {mind_err}): {tag}")
        if not (torch.equal(s1, s0) and torch.equal(n1, n0)):
            fail(f"assign_accumulate differs on integer data (max {sums_err}): {tag}")
    else:
        # best must agree wherever the two smallest plain distances are more
        # than 1e-4 of the distance scale apart (summation order moves d2 by
        # far less); mind, sums and counts to rtol 1e-5 of their scale.
        # float64 (not fast): mind on every row within the float64 bound
        # (f64_bound), and best wherever the two smallest plain distances lie
        # further apart than twice that bound
        d2 = c_sq[None, :] - 2.0 * D._mm(x, c.T, fast)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        scale = d2.abs().max().item()
        exact64 = dtype == np.float64 and not fast
        tol = f64_bound(d, x, c, scale) if exact64 else 1e-5 * scale
        clear = (two[:, 1] - two[:, 0]) > (2 * tol if exact64 else 1e-4 * scale)
        bad = int(((b1 != b0) & clear).sum())
        if bad:
            fail(f"assign_argmin best differs on {bad} clearly separated rows: {tag}")
        rows = slice(64 if tie_at is not None and not exact64 else 0, None)
        err = (m1[rows] - m0[rows]).abs().max().item() if n > rows.start else 0.0
        if err > tol:
            fail(f"assign_argmin mind error {err} > {tol} ({'the float64 bound' if exact64 else '1e-5 x scale'}): "
                 f"{tag}")
        if exact64:
            say(f"    max|mind err| {err:.3g} on every row (float64 bound {tol:.3g})")
        elif tie_at is not None:
            # the 64 rows lying on a center: their dot product with it is a
            # sum of d terms of one sign, as large as the scale itself. Each
            # route's float32 sum of the same (bf16 for `fast`) products lies
            # within d * 2^-24 * ||x|| ||c|| of the exact sum (the tensor
            # cores' float32 accumulation is no chain of round-to-nearest
            # additions), so c_sq - 2 dot may differ by 4 d 2^-24 ||x|| ||c||
            xq, cq = (D._bf16(x), D._bf16(c)) if fast else (x, c)
            tol = 4 * d * 2.0 ** -24 * float(D.row_sq(xq[:64].double()).max().sqrt()
                                              * D.row_sq(cq.double()).max().sqrt())
            on = (m1[:64] - m0[:64]).abs().max().item()
            if on > tol:
                fail(f"assign_argmin mind error {on} on the rows lying on a center > the float32 "
                     f"summation bound {tol}: {tag}")
            say(f"    rows lying on the tied center: max|mind err| {on:.3g} (summation bound {tol:.3g}); "
                f"other rows {err:.3g} (1e-5 x scale {1e-5 * scale:.3g})")
        if sums_err > 1e-5 * s0.abs().max().item():
            fail(f"assign_accumulate sums error {sums_err}: {tag}")
        if (n1 - n0).abs().max().item() > 1e-5 * n0.abs().max().item():
            fail(f"assign_accumulate counts differ: {tag}")
    say(f"  ok {tag}: best equal on {float((b1 == b0).float().mean()):.6f} of rows, "
        f"max|mind err| {mind_err:.3g}, max|sums err| {sums_err:.3g}")
    return mind_err, sums_err


# assign_accumulate's assignments besides the nearest-center one: every
# row on one center (a center of many pieces), a Zipf(1.1) law over the
# centers (the early Lloyd iterations of a random init, a dominant cluster),
# and edges: empty centers, zero weights, assignments outside [0, k)
SKEWS = ("one center", "zipf", "edges")


def _skewed(n, k, kind, seed):
    """(assignment int32 [n], rows whose weight is set to 0) for one SKEWS kind."""
    rng = np.random.default_rng(seed)
    zero = np.zeros(n, dtype=bool)
    if kind == "one center":
        a = np.full(n, 17 % k)
    elif kind == "zipf":
        p = np.arange(1, k + 1, dtype=np.float64) ** -1.1
        a = rng.permutation(k)[rng.choice(k, size=n, p=p / p.sum())]
    else:
        a = rng.integers(0, k, size=n)
        a[(a >= k // 3) & (a < k // 2)] = 0  # empty centers
        out = rng.random(n) < 0.125
        a[out] = rng.choice([-7, -1, k, k + 3], size=int(out.sum()))
        zero = rng.random(n) < 0.125
    return a.astype(np.int32), zero


def check_accumulate(n, k, d, dtype, fast, integer, seed, dev, kind):
    """assign_accumulate on a SKEWS assignment against accumulate_plain on
    the rows inside [0, k); two launches bitwise equal; returns max
    |sums err|."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    x, _, w = _inputs(n, k, d, dtype, integer, seed, dev)
    a, zero = _skewed(n, k, kind, seed)
    w[torch.from_numpy(zero).to(dev)] = 0
    assign = torch.from_numpy(a).to(dev)
    s1, n1 = _kernels.assign_accumulate(x, w, assign, k, fast=fast)
    s2, n2 = _kernels.assign_accumulate(x, w, assign, k, fast=fast)
    torch.cuda.synchronize()
    valid = (assign >= 0) & (assign < k)
    s0, n0 = D.accumulate_plain(x[valid], w[valid], assign[valid], k, fast)
    tag = (f"assign_accumulate {n}x{d} k={k} {np.dtype(dtype).name}{' fast' if fast else ''} "
           f"{'integer' if integer else 'gaussian'} [{kind}: most rows on one center "
           f"{int(np.bincount(a[(a >= 0) & (a < k)], minlength=k).max())}]")
    if not (torch.equal(s1, s2) and torch.equal(n1, n2)):
        fail(f"not deterministic: {tag}")
    err = (s1 - s0).abs().max().item()
    if integer:
        if not (torch.equal(s1, s0) and torch.equal(n1, n0)):
            fail(f"differs on integer data (max {err}): {tag}")
    else:
        if err > 1e-5 * s0.abs().max().item():
            fail(f"sums error {err} > 1e-5 x {s0.abs().max().item()}: {tag}")
        if (n1 - n0).abs().max().item() > 1e-5 * n0.abs().max().item():
            fail(f"counts differ: {tag}")
    say(f"  ok {tag}: max|sums err| {err:.3g}")
    return err


def time_kernels(variant, dev, errs):
    """Kernel, plain-version and library times at the main path's tile."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    dtype, fast = _variant_dtype(variant)
    x, c, w = _inputs(TILE_ROWS, K, N_COLS, dtype, False, 7, dev)
    c_sq = D._c_sq(c)
    _, best = _kernels.assign_argmin(x, c, c_sq, fast=fast)
    B, d, k, s = TILE_ROWS, N_COLS, K, x.element_size()
    out = []

    xm, cm = (x.bfloat16(), c.bfloat16()) if fast else (x, c)
    nbytes = (B * d + k * d + k) * s + B * (s + 4)
    flops = 2.0 * B * k * d
    bnd, by = bound_ms(nbytes, flops, variant)
    # the passes apart: the bf16 staging (`fast`), the tile pass, the merge
    xo, co = _kernels._argmin_operands(x, c, variant)
    pv, pj = _kernels._argmin_tiles(xo, co, c_sq, B, k, d, variant)
    split = {
        "stage_ms": cuda_ms(lambda: _kernels._argmin_operands(x, c, variant)) if fast else 0.0,
        "tiles_ms": cuda_ms(lambda: _kernels._argmin_tiles(xo, co, c_sq, B, k, d, variant)),
        "merge_ms": cuda_ms(lambda: _kernels._argmin_merge(pv, pj)),
    }
    # staging reads x and c once and writes their padded bf16 copies once
    stage_bytes = (B * d + k * d) * s + (xo.numel() + co.numel()) * 2 if fast else 0
    split["stage_bound_ms"] = stage_bytes / PEAK_BYTES_S * 1e3
    split["tiles_tflops"] = flops / split["tiles_ms"] / 1e9
    del xo, co, pv, pj
    out.append({
        "name": f"assign_argmin/{variant}",
        "route": "cuda",
        "source": "spark_rapids_ml_tpu_torch/csrc/assign_argmin.cu",
        "replaces": "spark_rapids_ml_tpu/ops/distance.py:224",
        "max_abs_err": errs[("assign_argmin", variant)],
        "ms": cuda_ms(lambda: _kernels.assign_argmin(x, c, c_sq, fast=fast)),
        "plain_ms": cuda_ms(lambda: D.assign_argmin_plain(x, c, c_sq, fast)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": cuda_ms(lambda: torch.matmul(xm, cm.T)),
        "split_ms": split,
        "ptxas": kernel_ptxas("assign_argmin", variant),
    })

    xw = x * w[:, None]

    def library_accumulate():
        sums = torch.zeros((k, d), dtype=x.dtype, device=dev)
        sums.index_add_(0, best.long(), xw)
        return sums

    nbytes = (B * d + B + k * d + k) * s + B * 4
    bnd, by = bound_ms(nbytes, 2.0 * B * d, variant)
    e = {
        "name": f"assign_accumulate/{variant}",
        "route": "cuda",
        "source": "spark_rapids_ml_tpu_torch/csrc/assign_accumulate.cu",
        "replaces": "spark_rapids_ml_tpu/ops/distance.py:297",
        "max_abs_err": errs[("assign_accumulate", variant)],
        "ms": cuda_ms(lambda: _kernels.assign_accumulate(x, w, best, k, fast=fast)),
        "plain_ms": cuda_ms(lambda: D.accumulate_plain(x, w, best, k, fast)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": cuda_ms(library_accumulate),
        "split_ms": accumulate_split(x, w, best, k, fast),
        "ptxas": kernel_ptxas("assign_accumulate", variant),
    }
    # the skewed assignments at the same tile: the whole call, and its passes
    for kind in ("one center", "zipf"):
        a, _ = _skewed(B, k, kind, 7)
        skew = torch.from_numpy(a).to(dev)
        e["split_ms"][kind] = dict(
            ms=cuda_ms(lambda: _kernels.assign_accumulate(x, w, skew, k, fast=fast)),
            **accumulate_split(x, w, skew, k, fast))
    e["device_ms"] = e["split_ms"]["device_ms"]["call"]
    out.append(e)
    for e in out:
        say(f"  {e['name']}: {e['ms']:.3f} ms (plain {e['plain_ms']:.3f}, library "
            f"{e['library_ms']:.3f}, bound {e['bound_ms']:.3f} by {e['bound_by']})")
    a = out[0]
    say(f"    passes: staging {a['split_ms']['stage_ms']:.3f} ms (its bytes at the memory rate "
        f"{a['split_ms']['stage_bound_ms']:.3f}), tiles {a['split_ms']['tiles_ms']:.3f} ms "
        f"({a['split_ms']['tiles_tflops']:.1f} TFLOP/s), merge {a['split_ms']['merge_ms']:.3f} ms; "
        f"ptxas {a['ptxas']}")
    sp = out[1]["split_ms"]
    dv = sp["device_ms"]
    say(f"    accumulate passes: preparation {sp['prep_ms']:.3f} ms, sums {sp['sums_ms']:.3f} ms, fold "
        f"{sp['fold_ms']:.3f} ms; on the card alone: call {dv['call']:.3f}, preparation "
        f"{dv['prep']:.3f}, sums {dv['sums']:.3f} ({sp['sums_tbs']:.2f} TB/s of 3.35), fold "
        f"{dv['fold']:.3f}; one center {sp['one center']['ms']:.3f} ms (alone "
        f"{sp['one center']['device_ms']['call']:.3f}), zipf {sp['zipf']['ms']:.3f} ms (alone "
        f"{sp['zipf']['device_ms']['call']:.3f}); ptxas {out[1]['ptxas']}")
    return out


def accumulate_split(x, w, assign, k, fast):
    """assign_accumulate's passes timed apart on one assignment: index
    preparation (counting sort and plan), the sum pass with its rate on the
    card (the bytes it must move: x, w and the row order read once, sums,
    counts and partials written once), and the fold; each with cuda_ms and,
    with the whole call, with device_ms."""
    from spark_rapids_ml_tpu_torch.ops import _kernels

    B, d = x.shape
    s = x.element_size()
    plan = _kernels._accumulate_prep(assign, k)
    sums, counts, part, part_counts = _kernels._accumulate_sums(x, w, plan, fast)
    passes = {
        "prep": lambda: _kernels._accumulate_prep(assign, k),
        "sums": lambda: _kernels._accumulate_sums(x, w, plan, fast),
        "fold": lambda: _kernels._accumulate_fold(sums, counts, part, part_counts, plan, fast),
    }
    out = {f"{name}_ms": cuda_ms(fn) for name, fn in passes.items()}
    out["device_ms"] = {name: device_ms(fn) for name, fn in passes.items()}
    out["device_ms"]["call"] = device_ms(lambda: _kernels.assign_accumulate(x, w, assign, k, fast=fast))
    n_pieces, n_multi = plan.totals.tolist()
    part_rows = int((plan.pieces[:n_pieces, 3] == 0).sum())
    out["pieces"], out["centers_of_several_pieces"] = n_pieces, n_multi
    sums_bytes = (B * d + B) * s + B * 4 + (k * d + k) * s + part_rows * (d * part.element_size() + s)
    out["sums_tbs"] = sums_bytes / out["device_ms"]["sums"] / 1e9
    return out


def check_batch_independence(dev):
    """assign_argmin on rows x[a:a+B] equals its result on the whole
    32768-row tile at the same rows, bit for bit (every variant, Gaussian
    data): one tiling and one split serve every batch size."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    for variant in VARIANTS:
        dtype, fast = _variant_dtype(variant)
        x, c, _ = _inputs(TILE_ROWS, K, N_COLS, dtype, False, 5, dev)
        c_sq = D._c_sq(c)
        m_full, b_full = _kernels.assign_argmin(x, c, c_sq, fast=fast)
        for B, a in BATCH_SLICES:
            m, b = _kernels.assign_argmin(x[a:a + B], c, c_sq, fast=fast)
            if not (torch.equal(m, m_full[a:a + B]) and torch.equal(b, b_full[a:a + B])):
                fail(f"assign_argmin/{variant}: rows {a}..{a + B} sent alone differ "
                     f"from the same rows of the {TILE_ROWS}-row tile")
        say(f"  ok batch independence, assign_argmin/{variant}: rows sent as batches of "
            f"{', '.join(str(B) for B, _ in BATCH_SLICES)} equal the same rows of the {TILE_ROWS}-row "
            "tile bit for bit")
        del x, c, c_sq, m_full, b_full


def _d2_inputs(B, kt, d, dtype, integer, seed, dev):
    g, tdt = _device_rng(seed, dev, dtype)
    if integer:  # every dot product and norm is exact in f32 and f64
        return _randint(g, -4, 5, (B, d), tdt), _randint(g, -4, 5, (kt, d), tdt)
    return _randn(g, (B, d), tdt), _randn(g, (kt, d), tdt)


def check_d2_block(B, kt, d, dtype, fast, integer, seed, dev):
    """d2_block against d2_block_plain at one shape; returns max |err|. The
    tolerance, 1e-5 of the block's scale, covers dot products summed in
    another order: in float32, or in float32 for `fast`; for float64 (not
    fast) it is the float64 bound (f64_bound)."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    q, xt = _d2_inputs(B, kt, d, dtype, integer, seed, dev)
    xt_sq = D.row_sq(xt)
    out = _kernels.d2_block(q, xt, xt_sq, fast=fast)
    torch.cuda.synchronize()
    ref = D.d2_block_plain(q, xt, xt_sq, fast)
    tag = (f"d2_block {B}x{kt}x{d} {np.dtype(dtype).name}{' fast' if fast else ''} "
           f"{'integer' if integer else 'gaussian'}")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        fail(f"{tag}: output {tuple(out.shape)} {out.dtype}, plain {tuple(ref.shape)} {ref.dtype}")
    err = (out - ref).abs().max().item()
    if integer and not torch.equal(out, ref):
        fail(f"{tag}: differs on integer data (max {err})")
    scale = ref.abs().max().item()
    exact64 = dtype == np.float64 and not fast
    tol = f64_bound(d, q, xt, scale) if exact64 else 1e-5 * scale
    if err > tol:  # dot products summed in another order
        fail(f"{tag}: max |err| {err} > {tol} ({'the float64 bound' if exact64 else f'1e-5 x {scale}'})")
    say(f"  ok {tag}: max|err| {err:.3g} (scale {scale:.4g}, tolerance {tol:.3g})")
    return err


def time_d2_block(variant, dev, err, d=N_COLS):
    """d2_block, its plain version and one library call at the kNN tile
    (depth `d`): for f32 and f64 one torch.addmm computing the same block
    (the bare torch.matmul product is timed beside it); for `fast`,
    torch.matmul on the two operands cast to bf16 beforehand (the casts not
    timed). The `fast` staging and the kernel are also timed apart."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    dtype, fast = _variant_dtype(variant)
    B, kt = KNN_QUERIES, D._DEFAULT_K_TILE
    q, xt = _d2_inputs(B, kt, d, dtype, False, 9, dev)
    xt_sq = D.row_sq(xt)
    s = q.element_size()
    flops = 2.0 * B * kt * d
    bnd, by = bound_ms((B * d + kt * d + kt + B * kt) * s, flops, variant)
    qo, xo = _kernels._d2_operands(q, xt, variant)
    split = {
        "stage_ms": cuda_ms(lambda: _kernels._d2_operands(q, xt, variant)) if fast else 0.0,
        "tiles_ms": cuda_ms(lambda: _kernels._d2_tiles(qo, xo, xt_sq, B, d, variant)),
    }
    # staging reads q and xt once and writes their padded bf16 copies once
    stage_bytes = (B * d + kt * d) * s + (qo.numel() + xo.numel()) * 2 if fast else 0
    split["stage_bound_ms"] = stage_bytes / PEAK_BYTES_S * 1e3
    split["tiles_tflops"] = flops / split["tiles_ms"] / 1e9
    del qo, xo
    e = {
        "name": f"d2_block/{variant}",
        "route": "cuda",
        "source": "spark_rapids_ml_tpu_torch/csrc/d2_block.cu",
        "replaces": "spark_rapids_ml_tpu/ops/distance.py:366",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: _kernels.d2_block(q, xt, xt_sq, fast=fast)),
        "plain_ms": cuda_ms(lambda: D.d2_block_plain(q, xt, xt_sq, fast)),
        "bound_ms": bnd, "bound_by": by,
    }
    if fast:
        qb, xb = q.bfloat16(), xt.bfloat16()
        e["library_ms"] = cuda_ms(lambda: torch.matmul(qb, xb.T))
        lib = f"torch.matmul bf16 {e['library_ms']:.3f}"
    else:
        e["library_ms"] = cuda_ms(lambda: torch.addmm(xt_sq[None, :], q, xt.T, alpha=-2.0))
        e["matmul_ms"] = cuda_ms(lambda: torch.matmul(q, xt.T))
        lib = f"torch.addmm {e['library_ms']:.3f}, torch.matmul {e['matmul_ms']:.3f}"
    split["tflops"] = flops / e["ms"] / 1e9
    split["bound_share"] = bnd / e["ms"]
    e["split_ms"] = split
    e["ptxas"] = kernel_ptxas("d2_block", variant)
    say(f"  {e['name']}: {e['ms']:.3f} ms ({split['tflops']:.1f} TFLOP/s, {split['bound_share']:.1%} of "
        f"the bound {e['bound_ms']:.3f} by {e['bound_by']}; plain {e['plain_ms']:.3f}, {lib})")
    say(f"    staging {split['stage_ms']:.3f} ms (its bytes at the memory rate "
        f"{split['stage_bound_ms']:.3f}), tiles {split['tiles_ms']:.3f} ms "
        f"({split['tiles_tflops']:.1f} TFLOP/s); ptxas {e['ptxas']}")
    return e


def check_d2_batch_independence(dev):
    """d2_block on rows q[a:a+B] equals its result on one 8192-row call at the
    same rows, bit for bit (every variant, Gaussian data, the kNN item
    block): one grid and tile serve every batch of the serving ladder."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    rows = max(SERVE_RUNGS)
    for variant in VARIANTS:
        dtype, fast = _variant_dtype(variant)
        q, xt = _d2_inputs(rows, D._DEFAULT_K_TILE, N_COLS, dtype, False, 13, dev)
        xt_sq = D.row_sq(xt)
        full = _kernels.d2_block(q, xt, xt_sq, fast=fast)
        for B, a in D2_BATCH_SLICES:
            if not torch.equal(_kernels.d2_block(q[a:a + B], xt, xt_sq, fast=fast), full[a:a + B]):
                fail(f"d2_block/{variant}: rows {a}..{a + B} sent alone differ from the "
                     f"same rows of the {rows}-row call")
        del full, q, xt, xt_sq
        say(f"  ok d2_block batch independence, {variant}: rows sent as batches "
            f"of {', '.join(str(B) for B, _ in D2_BATCH_SLICES)} equal the same rows of one {rows}-row "
            "call bit for bit")


def check_nan_query_rows(dev):
    """A query row of NaN through topk_tile on the card, in one item block
    and in several, f32 and f32-fast: the same indices as the plain route on
    the CPU, and in one block the row's first columns in order at NaN
    distance, as jax.lax.top_k ranks them; then a NaN row among 64 queries
    against one 16,384-item block at d = 3000."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import distance as D

    rng = np.random.default_rng(1)
    items = rng.standard_normal((300, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    q[1] = np.nan
    tq, ti = torch.from_numpy(q), torch.from_numpy(items)
    for fast in (False, True):
        for k_tile in (300, 64):
            cd, ci = D.topk_tile(tq, ti, None, 10, k_tile=k_tile, fast=fast)
            gd, gi = D.topk_tile(tq.to(dev), ti.to(dev), None, 10, k_tile=k_tile, fast=fast)
            gd, gi = gd.cpu(), gi.cpu()
            tag = f"NaN query row, {-(-300 // k_tile)} item block(s){' fast' if fast else ''}"
            if not torch.equal(gi, ci):
                fail(f"{tag}: the card's indices differ from the CPU's at {int((gi != ci).sum())} places")
            if not torch.equal(torch.isnan(gd), torch.isnan(cd)):
                fail(f"{tag}: NaN distances differ between the card and the CPU")
            want = torch.arange(10, dtype=torch.int32) if k_tile == 300 else torch.zeros(10, dtype=torch.int32)
            if not torch.equal(gi[1], want):
                fail(f"{tag}: the NaN row got indices {gi[1].tolist()}, expected {want.tolist()}")
    big_q, big_x = _d2_inputs(64, D._DEFAULT_K_TILE, N_COLS, np.float32, False, 17, dev)
    big_q[3] = float("nan")
    for fast in (False, True):
        d2, idx = D.topk_tile(big_q, big_x, None, KNN_K, fast=fast)
        if not (torch.equal(idx[3].cpu(), torch.arange(KNN_K, dtype=torch.int32))
                and bool(torch.isnan(d2[3]).all())):
            fail(f"NaN query row among {len(big_q)} x {D._DEFAULT_K_TILE} x {N_COLS}"
                 f"{' fast' if fast else ''}: indices {idx[3, :8].tolist()}...")
        others = torch.cat([d2[:3], d2[4:]])
        if not bool(torch.isfinite(others).all()):
            fail("a finite query row got a non-finite distance beside the NaN row")
    say("  ok NaN query rows on the card: one item block and five, f32 and f32-fast, the CPU's indices; "
        f"one block of {D._DEFAULT_K_TILE} x {N_COLS}: the NaN row's neighbours are items 0..{KNN_K - 1}")


def phase_d2_block(dev):
    from spark_rapids_ml_tpu_torch.ops import distance as D

    say("phase 2: d2_block against its plain version on the card")
    errs = {}
    kt = D._DEFAULT_K_TILE
    for variant in VARIANTS:
        dtype, fast = _variant_dtype(variant)
        # the kNN tile, a ragged one (B and kt not multiples of the tiles),
        # tiny ones, and the serving ladder's rungs (256 to 8192 rows) against
        # the kNN block and an odd one
        shapes = [(KNN_QUERIES, kt, N_COLS), (KNN_QUERIES - 1, kt - 1, N_COLS),
                  (37, 5, 3), (1, 1, 1), (65, 63, 17), (200, 1000, 77), (129, 130, 16)]
        if variant == "f32-fast":
            shapes += [(b, kt, N_COLS) for b in SERVE_RUNGS if b != KNN_QUERIES]
            shapes += [(b, 1001, N_COLS) for b in SERVE_RUNGS]
        if variant == "f32":  # UMAP's graph and transform tile (phase 12): d = 64
            shapes += [(KNN_QUERIES, kt, UMAP_COLS), (UMAP_ROWS[0] % KNN_QUERIES, UMAP_ROWS[0] % kt, UMAP_COLS)]
        for (B, kt_, d) in shapes:
            check_d2_block(B, kt_, d, dtype, fast, True, B + kt_ + d, dev)
            e = check_d2_block(B, kt_, d, dtype, fast, False, B + kt_ + d, dev)
            if (B, kt_, d) == (KNN_QUERIES, kt, N_COLS):
                errs[variant] = e
            elif (B, kt_, d) == (KNN_QUERIES, kt, UMAP_COLS):
                errs["f32/d64"] = e
    check_d2_batch_independence(dev)
    check_nan_query_rows(dev)
    say("phase 2: d2_block timing at the kNN tile (CUDA events, mean of 5 after a warm-up)")
    entries = [time_d2_block(variant, dev, errs[variant]) for variant in VARIANTS]
    say(f"phase 2: d2_block/f32 at UMAP's depth, {KNN_QUERIES} x {kt} x {UMAP_COLS}")
    e64 = time_d2_block("f32", dev, errs["f32/d64"], d=UMAP_COLS)
    entries[0]["at_d64"] = {k_: e64[k_] for k_ in ("ms", "plain_ms", "library_ms", "matmul_ms", "bound_ms",
                                                  "bound_by", "max_abs_err", "split_ms")}
    return entries


def phase_kernels(dev):
    from spark_rapids_ml_tpu_torch.ops import _kernels

    say("phase 2: kernels against their plain versions on the card")
    errs = {}
    for variant in VARIANTS:
        dtype, fast = _variant_dtype(variant)
        nt = _kernels.ARGMIN_TILE[variant][1]  # centers per tile of assign_argmin
        for integer in (True, False):
            # ragged shapes, then the main path's other tiles: the transform
            # tile, the ragged tail of a Lloyd iteration (1M = 30 x 32768 +
            # 16960) and the k-means|| candidate weighting (6 rounds x 2k
            # candidates, padded with repeated rows)
            for (n, k, d) in ((1000, 1001, 77), (37, 5, 3), (333, 64, 1000),
                              (4096, K, N_COLS), (N_ROWS % TILE_ROWS, K, N_COLS),
                              (4096, 12 * K, N_COLS), (TILE_ROWS, 256, ANN_PQ_DSUB)):
                case = ""
                if d == ANN_PQ_DSUB:
                    case = f"IVFPQ codebook tile: d = {d} (odd: the scalar path), k = {k}"
                elif k < nt:
                    case = f"k < {nt}: one partial center tile"
                elif k == 12 * K:
                    case = f"k-means|| weighting: {-(-k // nt)} center tiles of {nt}"
                check_kernels(n, k, d, dtype, fast, integer, 11 + n + k, dev, case)
            # a repeated center straddling the boundary of center tiles 0 and 1
            check_kernels(4096, 2 * nt + 37, N_COLS, dtype, fast, integer, 17 + nt, dev,
                          f"tie across the center-tile boundary at {nt}", tie_at=nt)
            m, s = check_kernels(TILE_ROWS, K, N_COLS, dtype, fast, integer, 3, dev)
            if not integer:
                errs[("assign_argmin", variant)] = m
                errs[("assign_accumulate", variant)] = s
            # assign_accumulate on skewed assignments: at the main tile,
            # small and ragged (several pieces, d not a multiple of 4), and
            # past the counting sort's centers (torch.sort prepares)
            for kind in SKEWS:
                for (n, k, d) in ((TILE_ROWS, K, N_COLS), (1000, 7, 77), (5000, 3, 130),
                                  (5000, 20000, 64)):
                    check_accumulate(n, k, d, dtype, fast, integer, 23 + n + k, dev, kind)
    check_batch_independence(dev)
    say("phase 2: timing at the main path's tile (CUDA events, mean of 5 after a warm-up)")
    entries = []
    for variant in VARIANTS:
        entries += time_kernels(variant, dev, errs)
    return entries


# ------------------------------------------------------------ phase 3 ----


PROTOCOL_CHUNK = 65536  # rows of one generator chunk of _protocol_rows


def _protocol_rows(lo=0, hi=None):
    """1M x 3000 float32 rows around 1000 Gaussian centers, from a seed. Row
    chunks are filled by threads, each with its own generator spawned from
    the seed, so the data is the same on every run and every machine. With
    `lo`/`hi` (multiples of PROTOCOL_CHUNK, or hi = N_ROWS) only rows [lo,
    hi) are made, the same values as those rows of the whole."""
    from concurrent.futures import ThreadPoolExecutor

    hi = N_ROWS if hi is None else hi
    seq = np.random.SeedSequence(2024)
    rng = np.random.default_rng(seq)
    true_centers = rng.standard_normal((K, N_COLS), dtype=np.float32) * 4.0
    labels = rng.integers(0, K, size=N_ROWS)
    X = np.empty((hi - lo, N_COLS), dtype=np.float32)
    starts = list(range(0, N_ROWS, PROTOCOL_CHUNK))
    chunk_seeds = seq.spawn(len(starts))
    if lo % PROTOCOL_CHUNK or (hi % PROTOCOL_CHUNK and hi != N_ROWS):
        fail(f"_protocol_rows({lo}, {hi}): not on the {PROTOCOL_CHUNK}-row chunk boundaries")

    def fill(i):
        a, b = starts[i], min(starts[i] + PROTOCOL_CHUNK, N_ROWS)
        np.random.default_rng(chunk_seeds[i]).standard_normal(dtype=np.float32, out=X[a - lo:b - lo])
        X[a - lo:b - lo] += true_centers[labels[a:b]]

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, [i for i, a in enumerate(starts) if lo <= a < hi]))
    return X


def _small_path_reference(float32_inputs=True):
    """The whole KMeans path on a small input, on the card and on the CPU
    (the plain PyTorch versions): same n_iter_, centers to rtol 1e-5
    (float64: 1e-9, the same assignments summed in another order),
    identical predictions."""
    from spark_rapids_ml_tpu_torch import KMeans, set_devices

    dtype = np.float32 if float32_inputs else np.float64
    tol = 1e-5 if float32_inputs else 1e-9
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((8, 40)).astype(dtype) * 5.0
    x = (centers[rng.integers(0, 8, 5000)] + rng.standard_normal((5000, 40))).astype(dtype)
    results = {}
    for device in ("cpu", "cuda"):
        set_devices(device)
        m = KMeans(k=8, maxIter=20, tol=1e-10, initMode="random", seed=3, distance_precision="high",
                   float32_inputs=float32_inputs).fit({"features": x})
        results[device] = (m, np.asarray(m.transform({"features": x})["prediction"]))
    set_devices(None)
    (mc, pc), (mg, pg) = results["cpu"], results["cuda"]
    tag = f"small path ({np.dtype(dtype).name})"
    if mc.n_iter_ != mg.n_iter_:
        fail(f"{tag}: n_iter_ {mg.n_iter_} on the card, {mc.n_iter_} on the CPU")
    if not np.allclose(mg.cluster_centers_, mc.cluster_centers_, rtol=tol, atol=tol):
        fail(f"{tag}: centers differ between the card and the CPU beyond rtol {tol}")
    if not np.array_equal(pg, pc):
        fail(f"{tag}: predictions differ between the card and the CPU")
    say(f"  {tag}, 5000 x 40, k=8: card and CPU agree (centers to rtol {tol}), n_iter_ {mg.n_iter_}, "
        f"inertia {mg.inertia_} vs {mc.inertia_}")


@contextlib.contextmanager
def _plain_kernels():
    """A context in which the argmin and accumulation kernels' wrappers are
    their plain versions (on the card, through cuBLAS) and count nothing:
    the path a port without its kernels would take."""
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    real = _kernels.assign_argmin, _kernels.assign_accumulate
    _kernels.assign_argmin = lambda x, c, c_sq, fast=False: D.assign_argmin_plain(x, c, c_sq, fast)
    _kernels.assign_accumulate = lambda x, w, a, k, fast=False: D.accumulate_plain(x, w, a, k, fast)
    try:
        yield
    finally:
        _kernels.assign_argmin, _kernels.assign_accumulate = real


def phase_main_path(dev, X):
    import torch

    from spark_rapids_ml_tpu_torch import KMeans, KMeansModel
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D

    say("phase 3: the KMeans path")
    _small_path_reference()
    data = {"features": X}
    counts = {}
    timings = {}

    # one reset, then a snapshot of the counters after each run: the per-run
    # counts are differences, and their sum is the whole main path's
    def run_counts(before):
        return {key: n - before.get(key, 0) for key, n in _kernels.launches.items()}

    _kernels.reset_launches()
    torch.cuda.synchronize()

    # fit, initMode="random"
    t0 = time.perf_counter()
    model = KMeans(k=K, maxIter=3, tol=1e-20, initMode="random", seed=1).setFeaturesCol("features").fit(data)
    timings["fit_s"] = time.perf_counter() - t0
    counts["fit"] = run_counts({})
    if model.cluster_centers_.shape != (K, N_COLS) or not np.isfinite(model.cluster_centers_).all():
        fail("fit: centers are not finite of shape (1000, 3000)")
    if not np.isfinite(model.inertia_):
        fail(f"fit: inertia {model.inertia_} is not finite")
    passes = model.n_iter_ + 1  # Lloyd iterations + the final high-precision inertia pass
    say(f"  fit (random init): {timings['fit_s']:.2f} s wall, n_iter_ {model.n_iter_}, "
        f"inertia {model.inertia_:.6e}, {N_ROWS * passes / timings['fit_s']:.4g} rows/s over "
        f"{passes} passes (placement and init included)")

    # transform
    snap = dict(_kernels.launches)
    t0 = time.perf_counter()
    pred = np.asarray(model.transform(data)["prediction"])
    timings["transform_s"] = time.perf_counter() - t0
    counts["transform"] = run_counts(snap)
    if pred.shape != (N_ROWS,) or pred.min() < 0 or pred.max() >= K:
        fail("transform: predictions out of range")
    say(f"  transform of {N_ROWS} rows: {timings['transform_s']:.2f} s wall")

    # save / load: the loaded model predicts the same
    path = ROOT / "build" / "chip_smoke_model"
    model.write().overwrite().save(str(path))
    loaded = KMeansModel.load(str(path))
    snap = dict(_kernels.launches)
    pred2 = np.asarray(loaded.transform(data)["prediction"])
    counts["loaded_transform"] = run_counts(snap)
    if not np.array_equal(pred, pred2):
        fail("save/load: the loaded model predicts differently")
    say("  save/load: the loaded model's transform equals the original's")

    # fit with the default k-means|| seeding (argmin kernel in the seeding)
    snap = dict(_kernels.launches)
    t0 = time.perf_counter()
    model2 = KMeans(k=K, maxIter=2, tol=1e-20, seed=1).fit(data)
    timings["fit_kmeans_parallel_s"] = time.perf_counter() - t0
    counts["fit_kmeans_parallel"] = run_counts(snap)
    if not np.isfinite(model2.inertia_) or not np.isfinite(model2.cluster_centers_).all():
        fail("k-means|| fit: non-finite result")
    say(f"  fit (k-means|| init): {timings['fit_kmeans_parallel_s']:.2f} s wall, "
        f"n_iter_ {model2.n_iter_}, inertia {model2.inertia_:.6e}")
    counts["main_path"] = dict(_kernels.launches)  # read just after the main path

    for run, c in counts.items():
        say(f"  launches in {run}: " + ", ".join(f"{k_}={v}" for k_, v in c.items() if v))

    def total(run, kernel):
        return sum(v for k_, v in counts[run].items() if k_.split("/")[0] == kernel)

    for run in ("fit", "fit_kmeans_parallel"):
        for kernel in ("assign_argmin", "assign_accumulate"):
            if total(run, kernel) == 0:
                fail(f"{run}: kernel {kernel} was never launched")
    for run in ("transform", "loaded_transform"):
        if total(run, "assign_argmin") == 0:
            fail(f"{run}: kernel assign_argmin was never launched")

    # after the counted runs: the host-to-device placement of X alone, the
    # fit's inertia against a plain reference on the card (the final
    # centers' nearest-center distances through the plain version, tile by
    # tile), one Lloyd iteration alone, and the transform's kernels alone on
    # device-resident rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xd = torch.from_numpy(X).to(dev)
    torch.cuda.synchronize()
    timings["place_rows_s"] = time.perf_counter() - t0
    say(f"  placing X on the card (host to device, {X.nbytes / 1e9:.1f} GB): "
        f"{timings['place_rows_s']:.2f} s")
    cd = torch.from_numpy(model.cluster_centers_).to(dev)
    c_sq = D._c_sq(cd)
    pred_d = torch.from_numpy(pred.astype(np.int64)).to(dev)
    ref = 0.0
    differ = differ_clear = 0
    for lo in range(0, N_ROWS, TILE_ROWS):
        xb = Xd[lo:lo + TILE_ROWS]
        mind, best = D.assign_argmin_plain(xb, cd, c_sq, False)
        ref += float(torch.sum(torch.clamp_min(mind + D.row_sq(xb), 0.0)))
        # the transform's predictions must equal the plain version's wherever
        # the two smallest plain distances are more than 1e-4 of the tile's
        # distance scale apart (the rule of phase 2)
        d2 = c_sq[None, :] - 2.0 * (xb @ cd.T)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-4 * d2.abs().max()
        wrong = best.long() != pred_d[lo:lo + TILE_ROWS]
        differ += int(wrong.sum())
        differ_clear += int((wrong & clear).sum())
    if differ_clear:
        fail(f"transform: {differ_clear} clearly separated rows differ from the plain version")
    say(f"  transform predictions equal the plain version's on every clearly separated row "
        f"({differ} of {N_ROWS} rows differ in all)")
    if abs(ref - model.inertia_) > 1e-4 * abs(ref):
        fail(f"fit: inertia {model.inertia_} disagrees with the plain reference {ref}")
    say(f"  inertia matches the plain reference {ref:.6e} (rtol 1e-4)")

    from spark_rapids_ml_tpu_torch.ops.kmeans import _lloyd_step

    wd = torch.ones(N_ROWS, device=dev)
    for route in ("kernels", "plain"):
        for fast in (True, False):
            # the plain route: the same iteration through the plain versions,
            # the path a port without its kernels would take on the card
            with _plain_kernels() if route == "plain" else contextlib.nullcontext():
                _lloyd_step(Xd, wd, cd, TILE_ROWS, fast)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, _, shift = _lloyd_step(Xd, wd, cd, TILE_ROWS, fast)
                float(shift)
                dt = time.perf_counter() - t0
            mode = "fast" if fast else "high"
            timings[f"lloyd_iter_{mode}_s" if route == "kernels" else f"plain_lloyd_iter_{mode}_s"] = dt
            say(f"  one Lloyd iteration ({mode}, {route}): {dt * 1e3:.1f} ms, "
                f"{N_ROWS / dt:.4g} rows/s")
    from spark_rapids_ml_tpu_torch.ops.kmeans import kmeans_predict

    snap = dict(_kernels.launches)
    timings["predict_resident_s"] = cuda_ms(lambda: kmeans_predict(Xd, cd), reps=2) / 1e3
    per_call = (_kernels.launches["assign_argmin/f32"] - snap["assign_argmin/f32"]) // 3
    say(f"  the transform's argmin over all rows already on the card: "
        f"{timings['predict_resident_s']:.4f} s ({per_call} assign_argmin/f32 launches of "
        f"{D.tile_rows()} rows)")
    for mode in ("fast", "high"):
        k_s, p_s = timings[f"lloyd_iter_{mode}_s"], timings[f"plain_lloyd_iter_{mode}_s"]
        say(f"  Lloyd iteration ({mode}): kernels {k_s * 1e3:.1f} ms, plain {p_s * 1e3:.1f} ms: "
            f"the kernel path is {'faster' if k_s < p_s else 'SLOWER'} ({p_s / k_s:.2f}x)")
    return counts, timings, model


# ------------------------------------------------------------ phase 4 ----


def _knn_routes(items, valid, queries, k):
    """exact_knn on resident tensors through the kernel and through the plain
    d2-block version (the same merge fed by d2_block_plain), in turns
    kernel, plain, plain, kernel; returns ({route: (dist, idx)}, {route:
    [seconds]})."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops.knn import exact_knn

    kernel_block = D.d2_block
    results, secs = {}, {"kernel": [], "plain": []}
    for route in ("kernel", "plain", "plain", "kernel"):
        D.d2_block = kernel_block if route == "kernel" else D.d2_block_plain
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[route] = exact_knn(items, valid, queries, k=k)
            secs[route].append(time.perf_counter() - t0)
        finally:
            D.d2_block = kernel_block
    return results, secs


def phase_knn(dev, X, d2_ms):
    import torch

    from spark_rapids_ml_tpu_torch import NearestNeighbors
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.parallel import place_rows

    say(f"phase 4: exact kNN, {KNN_QUERIES} queries x {N_ROWS} x {N_COLS} float32, k = {KNN_K}")
    kt = D._DEFAULT_K_TILE
    blocks = -(-N_ROWS // kt)
    expected = blocks * -(-KNN_QUERIES // D.tile_rows())
    timings = {}

    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = NearestNeighbors(k=KNN_K).setInputCol("features").fit({"features": X})
    timings["knn_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, knn_df = model.kneighbors({"features": X[:KNN_QUERIES]})
    timings["kneighbors_s"] = time.perf_counter() - t0
    counts = dict(_kernels.launches)  # read just after the path
    say("  launches in kneighbors: " + ", ".join(f"{k_}={v}" for k_, v in counts.items() if v))
    if counts["d2_block/f32"] != expected:
        fail(f"kneighbors: d2_block/f32 launched {counts['d2_block/f32']} times, expected "
             f"{expected} ({blocks} item blocks of {kt} x 1 query tile): a block took another route")
    if any(v for k_, v in counts.items() if k_ != "d2_block/f32"):
        fail(f"kneighbors: other kernels launched: {counts}")
    say(f"  fit {timings['knn_fit_s']:.2f} s (binds the item frame); kneighbors "
        f"{timings['kneighbors_s']:.2f} s wall through the API (placement of the items included)")

    idx = np.stack(knn_df["indices"].to_numpy())
    dist = np.stack(knn_df["distances"].to_numpy())
    if idx.shape != (KNN_QUERIES, KNN_K) or dist.shape != (KNN_QUERIES, KNN_K) or dist.dtype != np.float64:
        fail(f"kneighbors: indices {idx.shape}, distances {dist.shape} {dist.dtype}")
    if not np.isfinite(dist).all() or (np.diff(dist, axis=1) < 0).any():
        fail("kneighbors: distances not finite or not ascending")
    if not np.array_equal(knn_df["query_id"].to_numpy(), np.arange(KNN_QUERIES)):
        fail("kneighbors: query ids are not the row numbers")
    if not np.array_equal(idx[:, 0], np.arange(KNN_QUERIES)):
        fail(f"kneighbors: {int((idx[:, 0] != np.arange(KNN_QUERIES)).sum())} queries do not find themselves first")
    # ||q||^2 - 2 q.q + ||q||^2 in float32 is 0 up to ulps of ||q||^2
    q_sq = np.sum(X[:KNN_QUERIES].astype(np.float64) ** 2, axis=1)
    if (dist[:, 0] > np.sqrt(1e-5 * q_sq)).any():
        fail(f"kneighbors: a self-distance exceeds sqrt(1e-5 ||q||^2): max {dist[:, 0].max()}")
    say(f"  every query finds itself first (self-distance max {dist[:, 0].max():.4g}, "
        f"||q|| about {np.sqrt(q_sq.mean()):.4g}); nearest other row at {dist[:, 1].min():.4g}")

    # the kernel route against the plain route, on the same resident rows
    Xd, wd = place_rows(X, device=dev)
    Q = Xd[:KNN_QUERIES]
    valid = wd > 0
    res, secs = _knn_routes(Xd, valid, Q, KNN_K)
    (dk, ik), (dp, ip) = res["kernel"], res["plain"]
    d2k, d2p = dk.astype(np.float64) ** 2, dp.astype(np.float64) ** 2
    tol = 1e-5 * d2p.max()
    err = np.abs(d2k - d2p).max()
    if err > tol:
        fail(f"exact_knn: kernel and plain squared distances differ by {err} > 1e-5 x {d2p.max()}")
    swapped = np.argwhere(ik != ip)
    if len(swapped):
        # a swapped entry must be a near-tie: the kernel's item lies within
        # the tolerance of the plain route's distance at that position
        r, j = swapped[:, 0], swapped[:, 1]
        qd = Q[torch.from_numpy(r).to(dev)].double()
        xd = Xd[torch.from_numpy(ik[r, j].astype(np.int64)).to(dev)].double()
        exact = ((qd - xd) ** 2).sum(1).cpu().numpy()
        if (np.abs(exact - d2p[r, j]) > tol).any():
            fail(f"exact_knn: {int((np.abs(exact - d2p[r, j]) > tol).sum())} index swaps are not near-ties")
    timings["exact_knn_kernel_s"] = secs["kernel"]
    timings["exact_knn_plain_s"] = secs["plain"]
    say(f"  kernel route vs plain route: squared distances within {err:.4g} (tol {tol:.4g}); "
        f"{len(swapped)} of {ik.size} index positions differ, all near-ties")
    say(f"  exact_knn on resident items: kernel route {', '.join(f'{t:.3f}' for t in secs['kernel'])} s; "
        f"plain route {', '.join(f'{t:.3f}' for t in secs['plain'])} s")

    # the merge's share: one merge timed alone at the kNN tile, and the
    # kernel route's time less its blocks at the phase-2 kernel time
    item_sq = D.row_sq(Xd)
    block = D.d2_block(Q, Xd[:kt], item_sq[:kt])
    best_d2 = torch.full((KNN_QUERIES, KNN_K), float("inf"), device=dev)
    best_i = torch.zeros((KNN_QUERIES, KNN_K), dtype=torch.int32, device=dev)
    merge_ms = cuda_ms(lambda: D._merge(best_d2, best_i, block, 0, KNN_K))
    knn_s = min(secs["kernel"])
    timings["merge_ms"] = merge_ms
    timings["merge_share_timed"] = blocks * merge_ms / 1e3 / knn_s
    timings["merge_share_by_difference"] = (knn_s - blocks * d2_ms / 1e3) / knn_s
    say(f"  one merge at the kNN tile: {merge_ms:.3f} ms; merges {timings['merge_share_timed']:.1%} of "
        f"exact_knn ({blocks} x {merge_ms:.3f} ms), everything but d2_block "
        f"{timings['merge_share_by_difference']:.1%} ({blocks} x {d2_ms:.3f} ms of kernel)")
    del Xd, wd, Q, valid, item_sq, block

    # integer rows: exact in every sum, so the two routes must agree exactly;
    # rows repeated across item-block boundaries pin lower-index-first
    n_int = 8 * kt
    gen = torch.Generator(device=dev).manual_seed(31)
    items = torch.randint(-4, 5, (n_int, N_COLS), generator=gen, device=dev, dtype=torch.float32)
    for b in (kt, 4 * kt):
        items[b:b + 64] = items[b - 64:b]
    lo = kt - KNN_QUERIES // 2
    queries = items[lo:lo + KNN_QUERIES]
    res, _ = _knn_routes(items, None, queries, KNN_K)
    (dk, ik), (dp, ip) = res["kernel"], res["plain"]
    if not (np.array_equal(ik, ip) and np.array_equal(dk, dp)):
        fail(f"integer kNN: kernel and plain routes differ at {int((ik != ip).sum())} indices")
    orig = np.arange(kt - 64, kt)
    for rows in (orig - lo, orig + 64 - lo):  # the originals and their copies as queries
        if not (np.array_equal(ik[rows, 0], orig) and np.array_equal(ik[rows, 1], orig + 64)):
            fail("integer kNN: a repeated row does not come lower index first across the block boundary")
    say(f"  integer data, {KNN_QUERIES} x {n_int} x {N_COLS}, rows repeated across item blocks: kernel and "
        f"plain routes equal exactly; each repeated row ranks (lower copy, upper copy) first")
    del items, queries

    joined = model.exactNearestNeighborsJoin({"features": X[:5]})
    if len(joined) != 5 * KNN_K or "distCol" not in joined.columns:
        fail(f"exactNearestNeighborsJoin: {len(joined)} rows, columns {list(joined.columns)}")
    say(f"  exactNearestNeighborsJoin of 5 queries: {len(joined)} rows, columns {list(joined.columns)}")
    return counts, timings, (idx, dist)


# ------------------------------------------------------------ phase 5 ----


def _serve_traffic(seed, clients=SERVE_CLIENTS, requests=SERVE_REQUESTS, n_rows=None):
    """Per client thread, its requests as (first row, rows) of the first
    `n_rows` (default N_ROWS) rows of X: the sizes cycle through SERVE_SIZES
    (each thread starting elsewhere in the cycle, so concurrent requests
    differ in size), the first rows are seeded."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(clients):
        reqs = []
        for i in range(requests):
            n = SERVE_SIZES[(t + i) % len(SERVE_SIZES)]
            reqs.append((int(rng.integers(0, (n_rows or N_ROWS) - n)), n))
        out.append(reqs)
    return out


def _fast_topk_routes(q, items, item_sq, k):
    """topk_tile(fast=True) through the kernel and through the plain fast
    d2-block version, on the same resident tensors."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import distance as D

    kernel_block = D.d2_block
    out = {}
    for route in ("kernel", "plain"):
        D.d2_block = kernel_block if route == "kernel" else D.d2_block_plain
        try:
            d2, idx = D.topk_tile(q, items, None, k, item_sq=item_sq, fast=True)
            torch.cuda.synchronize()
            out[route] = (d2.cpu().numpy(), idx.cpu().numpy())
        finally:
            D.d2_block = kernel_block
    return out


def phase_serving(dev, X, kmeans_model):
    import threading

    import torch

    from spark_rapids_ml_tpu_torch import ModelRegistry, NearestNeighbors, ScoringEngine, telemetry
    from spark_rapids_ml_tpu_torch.core import PredictProgram, config
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops.knn import exact_knn

    say(f"phase 5: serving, {SERVE_CLIENTS} clients x {SERVE_REQUESTS} requests of "
        f"{SERVE_SIZES} rows to each of kmeans_f32, kmeans_bf16, knn_bf16 (k = {KNN_K} over "
        f"{N_ROWS} x {N_COLS}); config: bucket ladder from {config['transform_bucket_min_rows']} to "
        f"{config['serve_max_batch_rows']} rows, prewarm to {config['serve_prewarm_rows']}, coalesce "
        f"window {config['serve_coalesce_window_ms']} ms (adaptive {config['serve_adaptive_batching']})")
    torch.cuda.empty_cache()  # the earlier phases' freed blocks back to the card
    kt = D._DEFAULT_K_TILE
    blocks = -(-N_ROWS // kt)
    timings = {}
    ids = np.random.default_rng(77).permutation(N_ROWS).astype(np.int64) * 3 + 1000
    t0 = time.perf_counter()
    knn_model = NearestNeighbors(k=KNN_K).setInputCol("features").setIdCol("id").fit(
        {"features": X, "id": ids})
    timings["knn_fit_s"] = time.perf_counter() - t0

    telemetry.registry().reset()
    telemetry.enable()
    _kernels.reset_launches()
    torch.cuda.synchronize()
    registry = ModelRegistry()
    loads = (("kmeans_f32", kmeans_model, None), ("kmeans_bf16", kmeans_model, "bf16"),
             ("knn_bf16", knn_model, "bf16"))
    dispatches = {}
    # the prewarm inside each load timed on its own (it ends in a fetch,
    # which waits for the card); the rest of the load is admission and
    # placement
    real_prewarm = PredictProgram.prewarm
    prewarm_s = []

    def timed_prewarm(self, n_cols, *, max_rows=None):
        t = time.perf_counter()
        rungs = real_prewarm(self, n_cols, max_rows=max_rows)
        prewarm_s.append(time.perf_counter() - t)
        return rungs

    PredictProgram.prewarm = timed_prewarm
    try:
        entries = {}
        for name, model, serve_dtype in loads:
            t0 = time.perf_counter()
            entries[name] = registry.load(name, model, serve_dtype=serve_dtype)
            torch.cuda.synchronize()
            timings[f"load_{name}_s"] = time.perf_counter() - t0
            timings[f"prewarm_{name}_s"] = prewarm_s[-1]
    finally:
        PredictProgram.prewarm = real_prewarm
    for name, model, serve_dtype in loads:
        entry = entries[name]
        program = entry.program
        dispatches[name] = 0
        real = program.dispatch

        def counted(xb, _real=real, _name=name):
            dispatches[_name] += 1
            return _real(xb)

        program.dispatch = counted
        say(f"  load {name}: {timings[f'load_{name}_s']:.2f} s, of which prewarm of "
            f"{entry.prewarmed_rungs} rungs {timings[f'prewarm_{name}_s']:.2f} s; "
            f"{entry.resident_bytes / 1e9:.3f} GB admitted, largest term "
            f"{model._serve_metrics['admission']['largest_term']}")
    knn_rungs = registry.get("knn_bf16").prewarmed_rungs
    load_counts = dict(_kernels.launches)

    traffic = _serve_traffic(2026)
    futures = [[] for _ in range(SERVE_CLIENTS)]
    engine = ScoringEngine(registry).start()

    def client(t):
        for lo, n in traffic[t]:
            rows = X[lo:lo + n]
            futures[t].append([engine.submit(name, rows, tenant=name) for name, _, _ in loads])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = [[[f.result(timeout=600) for f in per_req] for per_req in fut_t] for fut_t in futures]
    timings["traffic_s"] = time.perf_counter() - t0
    stats = engine.stats()
    engine.stop()
    counts = dict(_kernels.launches)  # read just after the serving path
    served_rows = sum(n for reqs in traffic for _, n in reqs)
    say("  launches in loads and traffic: " + ", ".join(f"{k_}={v}" for k_, v in counts.items() if v))
    say(f"  dispatches after load: {dispatches}; kNN prewarmed rungs {knn_rungs}")
    expected = blocks * (knn_rungs + dispatches["knn_bf16"])
    if counts["d2_block/f32-fast"] != expected:
        fail(f"serving: d2_block/f32-fast launched {counts['d2_block/f32-fast']} times, expected "
             f"{expected} ({blocks} item blocks x {knn_rungs + dispatches['knn_bf16']} kNN dispatches)")
    if counts["d2_block/f32"] or counts["d2_block/f64"] or counts["d2_block/f64-fast"]:
        fail(f"serving: a d2_block variant other than f32-fast launched: {counts}")
    for variant in ("f32", "f32-fast"):
        if not counts[f"assign_argmin/{variant}"] > load_counts[f"assign_argmin/{variant}"]:
            fail(f"serving: assign_argmin/{variant} did not launch for the KMeans requests")
    timings.update({
        "rows_per_model": served_rows,
        "rows_per_s": 3 * served_rows / timings["traffic_s"],
        "e2e_p50_s": stats["e2e_p50_s"], "e2e_p99_s": stats["e2e_p99_s"],
        "batches": stats["batches"], "coalesced_batches": stats["coalesced_batches"],
        "requests": stats["requests"],
        "per_model": {name: stats["tenants"][name] for name, _, _ in loads},
        "dispatches": dict(dispatches),
    })
    say(f"  traffic: {3 * SERVE_CLIENTS * SERVE_REQUESTS} requests, {served_rows} rows per model, "
        f"{timings['traffic_s']:.2f} s wall, {timings['rows_per_s']:.4g} rows/s over the three models; "
        f"{stats['batches']} batches, {stats['coalesced_batches']} of them coalesced; e2e p50 "
        f"{stats['e2e_p50_s'] * 1e3:.1f} ms, p99 {stats['e2e_p99_s'] * 1e3:.1f} ms")
    for name, _, _ in loads:
        v = stats["tenants"][name]
        say(f"    {name}: e2e p50 {v['e2e_p50_s'] * 1e3:.1f} ms, p99 {v['e2e_p99_s'] * 1e3:.1f} ms; "
            f"queue wait p50 {v['queue_wait_p50_s'] * 1e3:.1f} ms, p99 {v['queue_wait_p99_s'] * 1e3:.1f} ms")

    # every response equals the same request served alone, bit for bit
    solo_engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
    t0 = time.perf_counter()
    try:
        for t in range(SERVE_CLIENTS):
            for (lo, n), got in zip(traffic[t], results[t]):
                for (name, _, _), g in zip(loads, got):
                    ref = solo_engine.score(name, X[lo:lo + n], timeout=600)
                    pairs = zip(g, ref) if isinstance(g, tuple) else [(g, ref)]
                    if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in pairs):
                        fail(f"serving: {name} response to rows {lo}..{lo + n} differs from the "
                             "same request served alone")
    finally:
        solo_engine.stop()
    timings["solo_s"] = time.perf_counter() - t0
    say(f"  every response equals the same request served alone, bit for bit "
        f"({timings['solo_s']:.2f} s to serve them one by one)")

    flips = total = 0
    knn_idx = {}
    for t in range(SERVE_CLIENTS):
        for (lo, n), (km32, km16, (kd, ki)) in zip(traffic[t], results[t]):
            rows = X[lo:lo + n]
            pred = np.asarray(kmeans_model.transform({"features": rows})["prediction"])
            if not np.array_equal(km32, pred):
                fail(f"serving: kmeans_f32 differs from KMeansModel.transform on rows {lo}..{lo + n}")
            flips += int((km16 != km32).sum())
            total += n
            if ki.shape != (n, KNN_K) or not np.array_equal(ki[:, 0], ids[lo:lo + n]):
                fail(f"serving: a knn_bf16 query among rows {lo}..{lo + n} does not find itself first")
            if not (np.isfinite(kd).all() and (np.diff(kd, axis=1) >= 0).all()):
                fail("serving: knn_bf16 distances not finite or not ascending")
            if t == 0:
                knn_idx[lo] = ki
    timings["kmeans_bf16_flips"] = flips
    say(f"  kmeans_f32 equals KMeansModel.transform on all {total} rows; kmeans_bf16 assigns "
        f"{flips} of them differently")
    say("  every knn_bf16 query finds its own id first")

    # the bf16 route's recall@64 against the float32 route on the resident
    # items, for client 0's query rows
    items, item_sq, _ = registry.get("knn_bf16").program.state
    lo_n = traffic[0]
    Q = torch.cat([items[lo:lo + n] for lo, n in lo_n])
    t0 = time.perf_counter()
    _, f32_idx = exact_knn(items, None, Q, k=KNN_K)
    timings["exact_knn_f32_s"] = time.perf_counter() - t0
    f32_ids = ids[f32_idx]
    bf16_ids = np.concatenate([knn_idx[lo] for lo, _ in lo_n])
    hits = sum(len(np.intersect1d(a, b)) for a, b in zip(bf16_ids, f32_ids))
    timings["recall_at_64"] = hits / f32_ids.size
    say(f"  recall@{KNN_K} of knn_bf16 against the float32 route, {len(Q)} queries: "
        f"{timings['recall_at_64']:.6f}")

    # on one 4096-row bucket, the kernel route of topk_tile(fast=True)
    # against the plain fast route on the same resident items
    lo = next(lo for lo, n in lo_n if n == KNN_QUERIES)
    q = items[lo:lo + KNN_QUERIES]
    routes = _fast_topk_routes(q, items, item_sq, KNN_K)
    (d2k, ik), (d2p, ip) = routes["kernel"], routes["plain"]
    # each route's dot product is a float32 sum of N_COLS exact bf16
    # products, in another order (tensor-core steps against cuBLAS); the
    # summation bound puts each within N_COLS * 2^-24 * ||q|| ||x|| of the
    # exact sum, so the two routes' squared distances (-2 dot) may differ by
    # up to 4 * N_COLS * 2^-24 * max ||q|| * max ||x||
    tol = 4 * N_COLS * 2.0 ** -24 * float(D.row_sq(q).max().sqrt() * item_sq.max().sqrt())
    err = float(np.abs(d2k.astype(np.float64) - d2p).max())
    if err > tol:
        fail(f"serving: kernel and plain fast squared distances differ by {err} > {tol} "
             "(the float32 summation bound)")
    swapped = np.argwhere(ik != ip)
    if len(swapped):
        r, j = swapped[:, 0], swapped[:, 1]
        qb = D._bf16(q[torch.from_numpy(r).to(dev)]).double()
        xs = items[torch.from_numpy(ik[r, j].astype(np.int64)).to(dev)]
        exact = (item_sq[torch.from_numpy(ik[r, j].astype(np.int64)).to(dev)].double()
                 - 2.0 * (qb * D._bf16(xs).double()).sum(1)).cpu().numpy()
        if (np.abs(exact - d2p[r, j]) > tol).any():
            fail(f"serving: {int((np.abs(exact - d2p[r, j]) > tol).sum())} fast index swaps are not near-ties")
    timings["fast_route_swaps"] = len(swapped)
    say(f"  fast top-k at a {KNN_QUERIES}-row bucket, kernel vs plain route: squared distances within "
        f"{err:.4g} (tol {tol:.4g}); {len(swapped)} of {ik.size} index positions differ, all near-ties")
    # where a kNN dispatch's time goes: the whole dispatch (host clock,
    # ending in a sync) against its 62 kernels and 62 merges timed alone
    program = registry.get("knn_bf16").program
    for B in (KNN_QUERIES, config["serve_max_batch_rows"]):
        rows = X[:B]
        program.dispatch(rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.dispatch(rows)
        torch.cuda.synchronize()
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        qb = items[:B]
        block = D.d2_block(qb, items[:kt], item_sq[:kt], fast=True)
        best_d2 = torch.full((B, KNN_K), float("inf"), device=dev)
        best_i = torch.zeros((B, KNN_K), dtype=torch.int32, device=dev)
        kernel_ms = cuda_ms(lambda: D.d2_block(qb, items[:kt], item_sq[:kt], fast=True))
        merge_ms = cuda_ms(lambda: D._merge(best_d2, best_i, block, 0, KNN_K))
        timings[f"dispatch_{B}"] = {"dispatch_ms": dispatch_ms, "kernel_ms": kernel_ms,
                                    "merge_ms": merge_ms}
        say(f"  one knn_bf16 dispatch at the {B}-row rung: {dispatch_ms:.1f} ms wall; {blocks} x "
            f"d2_block fast {kernel_ms:.3f} ms = {blocks * kernel_ms:.1f} ms, {blocks} x merge "
            f"{merge_ms:.3f} ms = {blocks * merge_ms:.1f} ms")
        del block, best_d2, best_i
    timings["serve_analytic_tflop"] = telemetry.registry().snapshot()["counters"].get("serve.flops", 0) / 1e12
    say(f"  analytic distance work of the traffic (the models' _serve_flop_estimate): "
        f"{timings['serve_analytic_tflop']:.2f} TFLOP, {timings['serve_analytic_tflop'] / timings['traffic_s']:.1f} "
        "TFLOP/s over its wall")
    del items, item_sq, Q, q, program
    registry.clear()

    # integer rows (exact in bf16, every sum exact in float32): the fast
    # kernel and plain routes agree exactly across item blocks, lower copy first
    n_int = 8 * kt
    gen = torch.Generator(device=dev).manual_seed(41)
    it = torch.randint(-4, 5, (n_int, N_COLS), generator=gen, device=dev, dtype=torch.float32)
    for b in (kt, 4 * kt):
        it[b:b + 64] = it[b - 64:b]
    lo = kt - KNN_QUERIES // 2
    routes = _fast_topk_routes(it[lo:lo + KNN_QUERIES], it, D.row_sq(it), KNN_K)
    (d2k, ik), (d2p, ip) = routes["kernel"], routes["plain"]
    if not (np.array_equal(ik, ip) and np.array_equal(d2k, d2p)):
        fail(f"serving: integer fast top-k differs between kernel and plain at {int((ik != ip).sum())} indices")
    orig = np.arange(kt - 64, kt)
    for rows in (orig - lo, orig + 64 - lo):
        if not (np.array_equal(ik[rows, 0], orig) and np.array_equal(ik[rows, 1], orig + 64)):
            fail("serving: a repeated row does not come lower index first in the fast top-k")
    say(f"  integer data, {KNN_QUERIES} x {n_int} x {N_COLS}, fast: kernel and plain routes equal exactly, "
        "repeated rows lower copy first across item blocks")
    del it
    telemetry.disable()
    return counts, timings


# ----------------------------------------------------------- phase 15 ----

# the serving saturation protocol (benchmark/bench_saturation.py's
# run_saturation_bench, its parameters and its five gates unchanged), run
# against the port with phase 3's KMeansModel at full width
SAT = {
    "request_rows": 32, "max_batch_rows": 128, "plateau_s": 2.0, "burst_s": 4.0, "recover_s": 1.5,
    "recover_timeout_s": 15.0, "concurrency": 4, "service_delay_s": 0.02, "overload_factor": 2.5,
    "burst_goodput_frac": 0.3, "recover_goodput_frac": 0.6,
}
SAT_TENANT = "default"
# the degraded-rung drill: request sizes, and the float64 kNN model's items
# (131,072 x 3000 float64, 3.1 GB; each resident program places its own copy)
DRILL_SIZES = (1, 100, 1000, 4096)
OVERLOAD_KNN_ITEMS = 131_072
# the float64 kNN drill's queries held against the plain bf16 reference over
# all items (every 16th of the 4096), and the floor of the degraded rung's
# recall@64 against the float64 rung: 0.985668 in two runs on these rows
# (H100 80GB HBM3, 700 W); the plain bf16 reference's own recall says
# what bf16 rounding costs here
REF_QUERY_STEP = 16
DEGRADED_RECALL_FLOOR = 0.98


def _bf16_of(a):
    """`a` rounded to bf16 as the fast kernel forms round it (float64 through
    float32), widened to float64, where a product of two such values is
    exact."""
    return a.float().bfloat16().double()


def _f32_sum_err(S):
    """Bound on |fl32(sum) - sum| for N_COLS terms whose magnitudes sum to S,
    summed in any order by float32 adds that round to nearest or truncate
    (u = 2^-23), as a tensor core's accumulator may."""
    nu = (N_COLS + 1) * 2.0 ** -23
    return nu / (1.0 - nu) * S


def _worst_swap(got, want, ref_got, ref_want, e_got, e_want):
    """Per row, the largest (ref[j] - ref[m]) / (e[j] + e[m]) over the ids j
    that the answer `got` [R, k] holds and the reference's answer `want`
    lacks, against the ids m that `want` holds and `got` lacks (0 where the
    two sets are equal). ref_* are the reference's squared distances of
    those ids, e_* the bounds on how far the answer's own values may lie
    from them. An answer whose every value lies within its bound of the
    reference can swap j for m only where that ratio is at most 1."""
    worst = np.zeros(len(got))
    for r in range(len(got)):
        mj, mm = ~np.isin(got[r], want[r]), ~np.isin(want[r], got[r])
        if mj.any():
            num = ref_got[r][mj][:, None] - ref_want[r][mm][None, :]
            worst[r] = (num / (e_got[r][mj][:, None] + e_want[r][mm][None, :])).max()
    return worst


def _kmeans_bf16_reference(requests, centers, got, dev):
    """The degraded KMeans rung's assignments against a plain reference on
    the card: ||c||^2 - 2 bf16(x).bf16(c) with the products and sums in
    float64, so that it differs from the rung only by the rung's float32
    sums. A row may be assigned apart from the reference's argmin only
    within those sums' bound. Planted errors: each row sent to another
    center at random (a wrong tile or offset; it must be caught), and to
    the reference's second-nearest center (what the check resolves;
    printed)."""
    import torch

    C = torch.as_tensor(centers, device=dev)
    Cb = _bf16_of(C)
    c_sq = (C.double() ** 2).sum(1)
    x = torch.as_tensor(np.concatenate(requests), device=dev)
    xb = _bf16_of(x)
    dots = xb @ Cb.T
    S = xb.abs() @ Cb.abs().T
    ref = c_sq[None, :] - 2.0 * dots
    u = 2.0 ** -23
    # the rung's float32 value: its norms, its sums, its last subtraction
    e = 2.0 * _f32_sum_err(S) + _f32_sum_err(c_sq)[None, :] + u * (c_sq[None, :] + 2.0 * S)
    best = torch.topk(ref, 2, dim=1, largest=False).indices
    a = torch.as_tensor(np.concatenate(got), device=dev).long()[:, None]

    def check(ids):
        return _worst_swap(*(t.cpu().numpy() for t in (
            ids, best[:, :1], ref.gather(1, ids), ref.gather(1, best[:, :1]), e.gather(1, ids),
            e.gather(1, best[:, :1]))))

    worst = check(a)
    k = len(centers)
    other = (best[:, :1] + torch.as_tensor(np.random.default_rng(18).integers(1, k, (len(x), 1)), device=dev)) % k
    caught = {name: float(np.mean(check(ids) > 1.0)) for name, ids in (("random", other), ("second", best[:, 1:2]))}
    return {"rows": len(x), "apart": int((a[:, 0] != best[:, 0]).sum()), "worst": float(worst.max()),
            "planted_caught": caught}


def _knn_bf16_reference(items, rows, gd, gi, pi, dev):
    """The degraded float64 kNN rung against a plain reference on the card
    for the queries items[rows], over all items: ||x||^2 + ||q||^2 -
    2 bf16(q).bf16(x), the products and sums in float64, so that it differs
    from the rung only by the rung's float32 sums. Each distance the rung
    returns must lie within those sums' bound of the reference's, and its
    neighbors may differ from the reference's top k only within the bounds
    of the two ids swapped: the worst-case bound, and a tight one from the
    errors measured on the returned ids. Two planted errors must be caught:
    a within-cluster scramble (the query itself and 63 of its nearest 128 at
    random) by either, and a shift at the boundary (ranks 57-64 exchanged
    for 65-72) by the tight one."""
    import torch

    kk = gi.shape[1]
    q = torch.as_tensor(items[rows], device=dev)
    qb = _bf16_of(q)
    q_sq = (q * q).sum(1)
    ref = torch.empty((len(rows), len(items)), dtype=torch.float64, device=dev)
    step = 16384
    for lo in range(0, len(items), step):
        x = torch.as_tensor(items[lo:lo + step], device=dev)
        ref[:, lo:lo + step] = (x * x).sum(1)[None, :] + q_sq[:, None] - 2.0 * (qb @ _bf16_of(x).T)
    near = torch.topk(ref, 2 * kk, dim=1, largest=False).indices  # ascending

    def bound(ids):
        """The bound on each (query, id)'s value, and its exact float64
        squared distance."""
        xs = torch.as_tensor(items[ids.cpu().numpy()], device=dev)  # [R, m, d]
        xb = _bf16_of(xs)
        S = (qb.abs()[:, None, :] * xb.abs()).sum(2)
        scale = (xs * xs).sum(2) + q_sq[:, None] + 2.0 * S
        exact = ((xs - q[:, None, :]) ** 2).sum(2)
        # the float32 sums, and the float64 steps of both sides
        return (2.0 * _f32_sum_err(S) + 1e-11 * scale).cpu().numpy(), exact.cpu().numpy()

    want = near[:, :kk]
    e_want = bound(want)[0]

    def check(ids, e_ids, e_w):
        return _worst_swap(ids.cpu().numpy(), want.cpu().numpy(), ref.gather(1, ids).cpu().numpy(),
                           ref.gather(1, want).cpu().numpy(), e_ids, e_w)

    a = torch.as_tensor(gi[rows], device=dev).long()
    e_a, exact_a = bound(a)
    worst = check(a, e_a, e_want)
    got_d2 = gd[rows] ** 2
    err = np.abs(got_d2 - ref.gather(1, a).clamp_min(0.0).cpu().numpy())
    # the tight tier: an id the rung did not return is taken to err by at
    # most 4 x the largest error measured on the ids it returned
    tight = np.full_like(e_a, 4.0 * err.max())
    worst_tight = check(a, tight, tight)
    gen = np.random.default_rng(17)
    pick = np.stack([np.concatenate([[0], 1 + np.sort(gen.choice(2 * kk - 1, kk - 1, replace=False))])
                     for _ in rows])
    scramble = near.gather(1, torch.as_tensor(pick, device=dev))
    shift = torch.cat([near[:, :kk - 8], near[:, kk:kk + 8]], dim=1)
    caught = {name: {"bound": float(np.mean(check(ids, bound(ids)[0], e_want) > 1.0)),
                     "tight": float(np.mean(check(ids, tight, tight) > 1.0))}
              for name, ids in (("scramble", scramble), ("shift", shift))}
    recall_ref = float(np.mean([len(np.intersect1d(w, p)) / kk for w, p in zip(want.cpu().numpy(), pi[rows])]))
    return {"queries": len(rows), "worst_swap": float(worst.max()), "worst_swap_tight": float(worst_tight.max()),
            "tight_tol": float(tight.flat[0]), "swapped_queries": int((worst > 0).sum()),
            "worst_dist_err": float((err / e_a).max()), "max_err_vs_ref": float(err.max()),
            "median_err_vs_ref": float(np.median(err)),
            "median_err_vs_f64": float(np.median(np.abs(got_d2 - exact_a))), "recall_ref_vs_f64": recall_ref,
            "planted_caught": caught}


def _closed_loop(engine, name, make_request, duration_s, concurrency, deadline_ms):
    """Closed-loop clients (bench_saturation._closed_loop): each thread
    submits, waits, repeats; a refusal backs off 10 ms and retries. Returns
    served rows, wall, rows/s, p50/p99 of the served requests, refusals."""
    import threading

    from spark_rapids_ml_tpu_torch.errors import ServeOverloadError, SrmlError

    latencies, refused, rows = [], [0], [0]
    lock = threading.Lock()
    t_end = time.perf_counter() + duration_s

    def client():
        while time.perf_counter() < t_end:
            feats = make_request()
            t0 = time.perf_counter()
            try:
                engine.submit(name, feats, deadline_ms=deadline_ms, tenant=SAT_TENANT).result(timeout=30)
            except ServeOverloadError:
                with lock:
                    refused[0] += 1
                time.sleep(0.01)
                continue
            except SrmlError:
                continue  # expiries under churn: counted by the engine
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                rows[0] += feats.shape[0]

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat = np.asarray(latencies) if latencies else np.zeros(1)
    return {"rows": rows[0], "wall_s": wall, "rows_per_sec": rows[0] / wall if wall > 0 else 0.0,
            "p50_s": float(np.percentile(lat, 50)), "p99_s": float(np.percentile(lat, 99)),
            "served": len(latencies), "refused": refused[0]}


def _saturation(X, kmeans_model):
    """Returns the figures and the (stopped) engine, whose ladder state the
    ops report of 15c reads. 15a: plateau (closed loop, calibrates the SLO, deadline and queue
    bound), burst (an open loop at overload_factor x the plateau, shaped by a
    chaos `burst` entry), recover (closed loop again once the tenant is back
    to healthy), with every dispatch delayed by a chaos `delay:stage=serve`
    entry; the lane's five gates, hard."""
    import itertools

    import torch

    from spark_rapids_ml_tpu_torch import ModelRegistry, ScoringEngine, telemetry
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.errors import ServeOverloadError, SrmlError
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops_plane import audit
    from spark_rapids_ml_tpu_torch.parallel import chaos

    p = SAT
    rr = p["request_rows"]
    gen = np.random.default_rng(15)
    pool = [np.ascontiguousarray(X[s:s + rr]) for s in gen.integers(0, len(X) - rr, size=32)]
    counter = itertools.count()

    def make_request():
        return pool[next(counter) % len(pool)]

    # fast windows, so the closed loop reacts at this timescale (they bind at
    # the first record after the reset)
    config.update(metrics_bucket_seconds=0.25, metrics_bucket_count=24, serve_coalesce_window_ms=2.0,
                  serve_adaptive_batching=True, serve_overload_hold_s=0.4, serve_degraded_dtype="bf16", slo=[])
    telemetry.registry().reset()
    telemetry.enable()
    audited_before = len(audit.decisions(kind="backpressure"))
    mark = telemetry.registry().mark()
    delay_entry = f"delay:stage=serve:seconds={p['service_delay_s']}:times=1000000"
    chaos.set_fault_plan(delay_entry)
    out = {}
    registry = ModelRegistry()
    t0 = time.perf_counter()
    entry = registry.load("satbench", kmeans_model)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    if entry.degraded_dtype != "bf16" or entry.degraded_program is None:
        fail("overload: the saturation model was loaded without its bf16 degraded rung")
    with ScoringEngine(registry, max_batch_rows=p["max_batch_rows"]) as engine:
        engine.score("satbench", make_request())  # the dispatch path warm
        plateau = _closed_loop(engine, "satbench", make_request, p["plateau_s"], p["concurrency"], 10_000.0)
        capacity = max(plateau["rows_per_sec"], 1.0)
        # the run's SLO: the threshold well above the plateau p99 (healthy
        # traffic never burns), the deadline a small multiple of it
        threshold_s = max(0.08, 4.0 * plateau["p99_s"])
        deadline_s = 2.5 * threshold_s
        config["serve_max_queue_rows"] = max(512, int(capacity))
        config["slo"] = [{"name": "saturation_p99", "kind": "latency", "histogram": "serve.e2e_s",
                          "threshold_s": threshold_s, "objective": 0.5, "fast_window_s": 1.0, "fast_burn": 1.0}]
        burst_rate = int(p["overload_factor"] * capacity)
        chaos.set_fault_plan(delay_entry + f";burst:stage=serve:rows={burst_rate}:seconds={p['burst_s']}")
        fault = chaos.maybe_burst_stage("serve")
        if fault is None or fault.rows != burst_rate:
            fail("overload: the chaos plan's burst entry did not fire")
        fast_before = _kernels.launches["assign_argmin/f32-fast"]
        futures, refusals = [], {"shed": 0, "throttle": 0, "other": 0}
        t_burst0 = t_next = time.perf_counter()
        while time.perf_counter() - t_burst0 < fault.seconds:
            try:
                futures.append(engine.submit("satbench", make_request(), deadline_ms=deadline_s * 1e3,
                                             tenant=SAT_TENANT))
            except ServeOverloadError as e:
                refusals[e.level if e.level in refusals else "other"] += 1
            t_next += rr / fault.rows
            lag = t_next - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        served_rows, burst_lat, expired = 0, [], 0
        for fut in futures:  # the drain: the tail still resolves, typed
            try:
                fut.result(timeout=60)
            except SrmlError:
                expired += 1
                continue
            served_rows += fut.rows
            burst_lat.append(fut.t_done - fut.t_submit)
        burst_wall = time.perf_counter() - t_burst0
        fast_burst = _kernels.launches["assign_argmin/f32-fast"] - fast_before
        lat = np.asarray(burst_lat) if burst_lat else np.zeros(1)
        burst = {"offered_rows_per_sec": float(burst_rate), "rows_per_sec": served_rows / burst_wall,
                 "p99_s": float(np.percentile(lat, 99)), "served": len(burst_lat), "expired": expired,
                 "refused": dict(refusals), "wall_s": burst_wall}
        t0 = time.perf_counter()
        level = "unknown"
        while time.perf_counter() - t0 < p["recover_timeout_s"]:
            try:
                engine.submit("satbench", make_request(), deadline_ms=10_000.0, tenant=SAT_TENANT).result(timeout=30)
            except SrmlError:
                time.sleep(0.02)
            level = engine.stats()["tenants"].get(SAT_TENANT, {}).get("level", "unknown")
            if level == "healthy":
                break
        recover_wait_s = time.perf_counter() - t0
        recover = _closed_loop(engine, "satbench", make_request, p["recover_s"], p["concurrency"], 10_000.0)
        stats = engine.stats()
    registry.evict("satbench")
    chaos.clear_fault_plan()
    config["slo"] = []
    transitions = sum(t.get("transitions", 0) for t in stats["tenants"].values())
    audited = audit.decisions(kind="backpressure")[audited_before:]
    verdicts = [d["verdict"] for d in audited]
    counters = telemetry.registry().delta(mark)["counters"]
    gates = {
        "zero_overdeadline_dispatches": (
            counters.get("serve.overdeadline_dispatches", 0.0) == 0.0,
            f"{counters.get('serve.overdeadline_dispatches', 0.0):g} request(s) dispatched past their deadline"),
        "bounded_p99": (
            burst["p99_s"] <= deadline_s + threshold_s,
            f"served p99 {burst['p99_s'] * 1e3:.0f} ms vs bound {(deadline_s + threshold_s) * 1e3:.0f} ms"),
        "burst_goodput": (
            burst["rows_per_sec"] >= p["burst_goodput_frac"] * capacity,
            f"{burst['rows_per_sec']:,.0f} rows/s under burst vs {p['burst_goodput_frac']:.2f} x plateau "
            f"{capacity:,.0f}"),
        "recover_goodput": (
            recover["rows_per_sec"] >= p["recover_goodput_frac"] * capacity,
            f"{recover['rows_per_sec']:,.0f} rows/s after recovery (level {level!r} after {recover_wait_s:.1f} s) "
            f"vs {p['recover_goodput_frac']:g} x plateau {capacity:,.0f}"),
        "ladder_engaged_and_audited": (
            transitions > 0 and len(audited) == transitions,
            f"{transitions} transition(s), {len(audited)} audited"),
    }
    out.update({
        "plateau_rows_per_sec": plateau["rows_per_sec"], "plateau_p99_ms": plateau["p99_s"] * 1e3,
        "burst_offered_rows_per_sec": burst["offered_rows_per_sec"], "burst_rows_per_sec": burst["rows_per_sec"],
        "burst_p99_ms": burst["p99_s"] * 1e3, "burst_served": burst["served"], "burst_expired": expired,
        "recover_rows_per_sec": recover["rows_per_sec"], "recover_p99_ms": recover["p99_s"] * 1e3,
        "recover_wait_s": recover_wait_s, "final_level": level, "threshold_ms": threshold_s * 1e3,
        "deadline_ms": deadline_s * 1e3, "refusals_by_rung": burst["refused"], "transitions": transitions,
        "verdicts": verdicts,
        "counters": {k: counters.get(k, 0.0) for k in (
            "serve.requests", "serve.expired_requests", "serve.rejected_requests", "serve.shed_requests",
            "serve.throttled_requests", "serve.degraded_requests", "serve.degraded_rows",
            "serve.overdeadline_dispatches", "serve.degraded_fallbacks")},
        "f32_fast_launches_burst": fast_burst,
        "gates": {k: ok for k, (ok, _) in gates.items()},
    })
    say(f"  15a plateau {plateau['rows_per_sec']:,.0f} rows/s, p99 {plateau['p99_s'] * 1e3:.1f} ms "
        f"({plateau['served']} requests); SLO threshold {threshold_s * 1e3:.0f} ms, deadline "
        f"{deadline_s * 1e3:.0f} ms, queue bound {config['serve_max_queue_rows']} rows")
    say(f"  15a burst offered {burst_rate:,} rows/s for {p['burst_s']} s: served {burst['rows_per_sec']:,.0f} "
        f"rows/s, p99 {burst['p99_s'] * 1e3:.1f} ms, {burst['served']} served, {expired} expired; refusals by "
        f"rung {burst['refused']}; assign_argmin/f32-fast launches in the burst {fast_burst}")
    say(f"  15a recover: healthy after {recover_wait_s:.2f} s, then {recover['rows_per_sec']:,.0f} rows/s, p99 "
        f"{recover['p99_s'] * 1e3:.1f} ms; ladder verdicts {verdicts}; counters {out['counters']}")
    for k, (ok, detail) in gates.items():
        say(f"  15a gate {k}: {'ok' if ok else 'FAILED'} ({detail})")
    failed = [k for k, (ok, _) in gates.items() if not ok]
    if failed:
        fail("overload: saturation gates failed: " + "; ".join(f"{k}: {gates[k][1]}" for k in failed))
    if not counters.get("serve.degraded_requests"):
        fail("overload: no request was served on the degraded rung during the burst")
    if fast_burst <= 0:
        fail("overload: assign_argmin/f32-fast did not launch during the burst")
    return out, engine


def _counting(program, name, buckets):
    """Wrap `program.dispatch` to record each dispatched bucket's rows."""
    from spark_rapids_ml_tpu_torch.parallel import bucket_size

    real = program.dispatch

    def dispatch(xb):
        buckets.setdefault(name, []).append(bucket_size(len(xb), min_rows=program.bucket_min, cap=program.cap))
        return real(xb)

    program.dispatch = dispatch


def _drill(dev, X, kmeans_model):
    """15b: the degrade rung forced (`force_level`, as the JAX package's test
    does) for KMeans and for a float64 kNN model; each degraded response
    against a registry that serves the model at serve_dtype="bf16", bit for
    bit, the fast forms' launches against the dispatches; shed and throttle
    refusals typed. Returns the registries and engines 15c reads."""
    import torch

    from spark_rapids_ml_tpu_torch import ModelRegistry, NearestNeighbors, ScoringEngine
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.errors import ServeOverloadError
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.serving.overload import LEVEL_DEGRADE, LEVEL_SHED, LEVEL_THROTTLE

    out = {}
    # degrade sits above throttle on the ladder: a drill meters nothing
    config.update(serve_degraded_dtype="bf16", serve_throttle_rows_per_s=1e12, slo=[])
    registry, ref = ModelRegistry(), ModelRegistry()
    t0 = time.perf_counter()
    registry.load("km", kmeans_model)
    ref.load("km16", kmeans_model, serve_dtype="bf16")
    torch.cuda.synchronize()
    out["kmeans_loads_s"] = time.perf_counter() - t0
    buckets = {}
    _counting(registry.get("km").degraded_program, "km", buckets)
    gen = np.random.default_rng(16)
    requests = [X[lo:lo + n] for lo, n in zip(gen.integers(0, len(X) - 4096, size=len(DRILL_SIZES)), DRILL_SIZES)]
    engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
    ref_engine = ScoringEngine(ref, coalesce_window_s=0.0).start()
    engines = [engine, ref_engine]
    engine._overload.force_level("drill", LEVEL_DEGRADE)
    before = dict(_kernels.launches)
    got = [engine.submit("km", q, tenant="drill").result(600) for q in requests]
    fast = _kernels.launches["assign_argmin/f32-fast"] - before["assign_argmin/f32-fast"]
    f32 = _kernels.launches["assign_argmin/f32"] - before["assign_argmin/f32"]
    want = [ref_engine.score("km16", q, timeout=600) for q in requests]
    for q, g, w in zip(requests, got, want):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            fail(f"overload: a degraded KMeans response of {len(q)} rows differs from bf16 serving")
    tiles = sum(-(-b // D.tile_rows()) for b in buckets["km"])
    if fast != tiles or f32:
        fail(f"overload: the degraded KMeans dispatches launched assign_argmin/f32-fast {fast} times (expected "
             f"{tiles}, the dispatched buckets' tiles {buckets['km']}) and assign_argmin/f32 {f32} times")
    flips = sum(int((g != kmeans_model._transform_arrays(q)).sum()) for q, g in zip(requests, got))
    t0 = time.perf_counter()
    kref = _kmeans_bf16_reference(requests, kmeans_model.cluster_centers_, got, dev)
    kref["s"] = time.perf_counter() - t0
    if kref["worst"] > 1.0 or kref["planted_caught"]["random"] < 0.99:
        fail(f"overload: the degraded KMeans assignments against the plain bf16 reference: {kref} (a row apart "
             "from the reference's argmin must be a tie within the float32 sums' bound, worst <= 1; the planted "
             "random assignments must be caught in >= 0.99 of the rows)")
    out.update({"kmeans_f32_fast_launches": fast, "kmeans_buckets": buckets["km"], "kmeans_bf16_flips": flips,
                "kmeans_bf16_reference": kref})
    say(f"  15b KMeans degraded: {len(requests)} requests of {DRILL_SIZES} rows equal bf16 serving bit for bit; "
        f"assign_argmin/f32-fast {fast} launches = the tiles of buckets {buckets['km']}; {flips} rows assigned "
        f"apart from the float32 rung; against the plain bf16 reference (float64 sums) {kref['apart']} of "
        f"{kref['rows']} rows apart from its argmin, the largest excess {kref['worst']:.3g} x the float32 sums' "
        f"bound; planted errors caught (share of rows): {kref['planted_caught']}")

    # shed and throttle refuse, typed, with their level
    engine._overload.force_level("shed_me", LEVEL_SHED)
    config["serve_throttle_rows_per_s"] = 10.0  # a 10-row bucket: a 32-row request is refused
    engine._overload.force_level("slow", LEVEL_THROTTLE)
    levels = {}
    for tenant in ("shed_me", "slow"):
        try:
            engine.submit("km", requests[1][:32], tenant=tenant)
            fail(f"overload: tenant {tenant!r} was admitted at its forced level")
        except ServeOverloadError as e:
            levels[tenant] = e.level
    config["serve_throttle_rows_per_s"] = 1e12
    if levels != {"shed_me": "shed", "slow": "throttle"}:
        fail(f"overload: refusals carry levels {levels}")
    say(f"  15b refusals typed ServeOverloadError with their levels: {levels}")

    # the float64 kNN model: its primary rung runs d2_block/f64, its
    # degraded rung d2_block/f64-fast (the form's first path)
    t0 = time.perf_counter()
    items = np.ascontiguousarray(X[:OVERLOAD_KNN_ITEMS], dtype=np.float64)
    knn = NearestNeighbors(k=KNN_K, float32_inputs=False).setInputCol("features").fit({"features": items})
    registry.load("knn64", knn)
    ref.load("knn64_16", knn, serve_dtype="bf16")
    torch.cuda.synchronize()
    out["knn_loads_s"] = time.perf_counter() - t0
    entry = registry.get("knn64")
    out["knn_resident_gb"] = entry.resident_bytes / 1e9
    _counting(entry.degraded_program, "knn64", buckets)
    blocks = -(-OVERLOAD_KNN_ITEMS // D._DEFAULT_K_TILE)
    Q = items[:KNN_QUERIES]
    t0 = time.perf_counter()
    pd_, pi = engine.submit("knn64", Q, tenant="primary").result(600)
    out["knn_primary_s"] = time.perf_counter() - t0
    before = dict(_kernels.launches)
    t0 = time.perf_counter()
    gd, gi = engine.submit("knn64", Q, tenant="drill").result(600)
    out["knn_degraded_s"] = time.perf_counter() - t0
    f64_fast = _kernels.launches["d2_block/f64-fast"] - before["d2_block/f64-fast"]
    f64 = _kernels.launches["d2_block/f64"] - before["d2_block/f64"]
    wd, wi = ref_engine.score("knn64_16", Q, timeout=600)
    if not (gd.dtype == wd.dtype and np.array_equal(gd, wd) and np.array_equal(gi, wi)):
        fail("overload: the degraded float64 kNN response differs from bf16 serving")
    want_launches = blocks * len(buckets["knn64"])
    if f64_fast != want_launches or f64:
        fail(f"overload: the degraded kNN dispatches launched d2_block/f64-fast {f64_fast} times (expected "
             f"{want_launches} = {blocks} item blocks x {len(buckets['knn64'])} dispatches) and d2_block/f64 {f64}")
    if pd_.dtype != np.float64 or not np.array_equal(pi[:, 0], np.arange(KNN_QUERIES)):
        fail("overload: the float64 primary rung's queries do not find themselves first")
    if not (np.isfinite(gd).all() and (np.diff(gd, axis=1) >= 0).all()):
        fail("overload: degraded kNN distances not finite or not ascending")
    recall = sum(len(np.intersect1d(a, b)) for a, b in zip(gi, pi)) / pi.size
    t0 = time.perf_counter()
    kn = _knn_bf16_reference(items, np.arange(0, KNN_QUERIES, REF_QUERY_STEP), gd, gi, pi, dev)
    kn["s"] = time.perf_counter() - t0
    gates = {
        "neighbors within ties of the plain bf16 reference": kn["worst_swap"] <= 1.0,
        "neighbors within the tight ties": kn["worst_swap_tight"] <= 1.0,
        "distances within the float32 sums' bound of it": kn["worst_dist_err"] <= 1.0,
        "nearer the bf16 reference than exact float64": kn["median_err_vs_ref"] < kn["median_err_vs_f64"],
        "the planted within-cluster scramble caught": min(kn["planted_caught"]["scramble"].values()) >= 0.99,
        "the planted boundary shift caught by the tight ties": kn["planted_caught"]["shift"]["tight"] >= 0.99,
        f"recall@{KNN_K} >= {DEGRADED_RECALL_FLOOR}": recall >= DEGRADED_RECALL_FLOOR,
    }
    out.update({"knn_f64_fast_launches": f64_fast, "knn_recall_at_64": recall, "knn_bf16_reference": kn,
                "knn_self_first_degraded": float(np.mean(gi[:, 0] == np.arange(KNN_QUERIES)))})
    say(f"  15b float64 kNN ({OVERLOAD_KNN_ITEMS} x {N_COLS} items, k = {KNN_K}, {KNN_QUERIES} queries; "
        f"{out['knn_resident_gb']:.2f} GB admitted for both rungs; loads {out['knn_loads_s']:.2f} s): primary "
        f"{out['knn_primary_s']:.3f} s, degraded {out['knn_degraded_s']:.3f} s, equal to bf16 serving bit for bit; "
        f"d2_block/f64-fast {f64_fast} launches = {blocks} blocks x {len(buckets['knn64'])} dispatches; "
        f"recall@{KNN_K} against the float64 rung {recall:.6f}")
    say(f"  15b against the plain bf16 reference (float64 sums, all items) on {kn['queries']} queries: "
        f"{kn['swapped_queries']} with a neighbor apart, the largest excess {kn['worst_swap']:.3g} x the two "
        f"ids' float32 bounds, {kn['worst_swap_tight']:.3g} x the tight ties ({kn['tight_tol']:.3g} an id); "
        f"distances within {kn['worst_dist_err']:.3g} x their bound (|error| max {kn['max_err_vs_ref']:.3g}, "
        f"median {kn['median_err_vs_ref']:.3g}, against exact float64 {kn['median_err_vs_f64']:.3g}); the reference's "
        f"own recall@{KNN_K} against the float64 rung {kn['recall_ref_vs_f64']:.6f}; planted errors caught: "
        f"{kn['planted_caught']} ({kn['s']:.2f} s)")
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        fail("overload: the degraded float64 kNN rung: " + "; ".join(failed) + f" failed ({kn}, recall {recall})")
    return out, (registry, ref, engines, knn, items)


def _ops_plane(drill_state):
    """15c: the exporter on an ephemeral port scraped once (/metrics shows
    15a's serve.* counters; /healthz answers), report()'s serving and
    decision sections, and an SRML_NUMCHECK=1 sweep of one degraded
    response."""
    import urllib.error
    import urllib.request

    from spark_rapids_ml_tpu_torch import ScoringEngine, ops_plane, telemetry
    from spark_rapids_ml_tpu_torch.serving.overload import LEVEL_DEGRADE
    from spark_rapids_ml_tpu_torch.utils import numcheck

    registry = drill_state[0]
    out = {}
    os.environ["SRML_METRICS_PORT"] = "0"
    try:
        host, port = ops_plane.ensure_server()
        body = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30).read().decode()
        counters = telemetry.registry().snapshot()["counters"]
        for name in ("serve.requests", "serve.shed_requests", "serve.degraded_requests",
                     "serve.backpressure_transitions"):
            line = f'srml_{name.replace(".", "_")}{{rank="0"}} {counters.get(name, 0.0):g}'
            if counters.get(name) and line not in body:
                fail(f"overload: /metrics lacks {line!r}")
        try:
            health = urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30).status
        except urllib.error.HTTPError as e:
            health = e.code
        if health not in (200, 503):
            fail(f"overload: /healthz answered {health}")
        out.update({"metrics_lines": body.count("\n"), "healthz": health})
    finally:
        ops_plane.stop_server()
        os.environ.pop("SRML_METRICS_PORT", None)
    rep = ops_plane.report()
    tenants = rep["serving"]["tenants"]
    if not {SAT_TENANT, "drill"} <= set(tenants):
        fail(f"overload: report()'s serving section lacks the tenants: {sorted(tenants)}")
    backpressure = [d for d in rep["decisions"] if d["kind"] == "backpressure"]
    if not backpressure:
        fail("overload: report() carries no backpressure decision")
    os.environ["SRML_NUMCHECK"] = "1"
    state = numcheck.snapshot()
    numcheck.reset()
    try:
        engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
        try:
            engine._overload.force_level("drill", LEVEL_DEGRADE)
            fut = engine.submit("knn64", drill_state[4][:256], tenant="drill")
            fut.result(600)
            if not fut.degraded:
                fail("overload: the numcheck request was not served on the degraded rung")
        finally:
            engine.stop()
        sweep = {"checks": numcheck.checks(), "trips": numcheck.trips(),
                 "watermarks": numcheck.watermarks().get("serving.response")}
    finally:
        numcheck.restore(state)
        os.environ.pop("SRML_NUMCHECK", None)
    if sweep["trips"] or not sweep["checks"] or not sweep["watermarks"]:
        fail(f"overload: the SRML_NUMCHECK=1 sweep of a degraded response: {sweep}")
    out.update({"report_tenants": sorted(tenants), "backpressure_decisions": len(backpressure),
                "numcheck": sweep})
    say(f"  15c /metrics on {host}:{port}: {out['metrics_lines']} lines with 15a's serve.* counters; /healthz "
        f"{health}; report(): tenants {sorted(tenants)}, {len(backpressure)} backpressure decisions; numcheck "
        f"sweep of a degraded response: {sweep['checks']} checks, no trip, watermarks {sweep['watermarks']}")
    return out


def phase_overload(dev, X, kmeans_model):
    import torch

    from spark_rapids_ml_tpu_torch import telemetry
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops_plane import slo
    from spark_rapids_ml_tpu_torch.parallel import chaos

    say(f"phase 15: serving overload and the ops plane, KMeans(k = {K}) over {N_COLS} columns; the saturation "
        f"protocol {SAT}, then the degraded-rung drill and the ops plane")
    torch.cuda.empty_cache()
    keys = ("metrics_bucket_seconds", "metrics_bucket_count", "serve_coalesce_window_ms", "serve_adaptive_batching",
            "serve_overload_hold_s", "serve_degraded_dtype", "slo", "serve_max_queue_rows",
            "serve_throttle_rows_per_s")
    saved = {k: config[k] for k in keys}
    drill_state = None
    _kernels.reset_launches()  # this phase's counts: the run "overload"
    try:
        timings = {}
        timings["saturation"], sat_engine = _saturation(X, kmeans_model)
        timings["drill"], drill_state = _drill(dev, X, kmeans_model)
        timings["ops_plane"] = _ops_plane(drill_state)
        del sat_engine
    finally:
        counts = dict(_kernels.launches)
        if drill_state is not None:
            for engine in drill_state[2]:
                engine.stop()
            drill_state[0].clear()
            drill_state[1].clear()
        chaos.clear_fault_plan()
        config.update(saved)
        slo.reset()
        telemetry.disable()
        telemetry.registry().reset()
    del drill_state
    torch.cuda.empty_cache()
    say("  launches in phase 15: " + ", ".join(f"{k_}={v}" for k_, v in counts.items() if v))
    return counts, timings


# ------------------------------------------------------------ phase 6 ----

# the float64 route: Lloyd iterations of its fit, and its serving traffic
F64_MAX_ITER, F64_SERVE_CLIENTS, F64_SERVE_REQUESTS = 3, 2, 4


def _f64_rows(X):
    """The protocol rows as a new float64 block, converted by row chunks in
    threads."""
    from concurrent.futures import ThreadPoolExecutor

    X64 = np.empty(X.shape, dtype=np.float64)
    step = 65536

    def fill(lo):
        X64[lo:lo + step] = X[lo:lo + step]

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(fill, range(0, X.shape[0], step)))
    return X64


def _host_memory_gb():
    """(total, available) host memory in GB, from /proc/meminfo."""
    info = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, _, val = line.partition(":")
        info[key] = int(val.split()[0]) * 1024
    return info["MemTotal"] / 1e9, info["MemAvailable"] / 1e9


def phase_f64(dev, X):
    """The float64 route (float32_inputs=False) through the public API at
    the protocol width: KMeans fit, transform and save/load, exact kNN, and
    the serving plane with the f64 and f64-fast forms. Returns ({run:
    launches}, timings); the run "route" sums the counted runs."""
    import threading

    import torch

    from spark_rapids_ml_tpu_torch import (KMeans, KMeansModel, ModelRegistry, NearestNeighbors, ScoringEngine,
                                           telemetry)
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops.kmeans import _lloyd_step
    from spark_rapids_ml_tpu_torch.parallel import place_rows

    say(f"phase 6: the float64 route (float32_inputs=False), {N_ROWS} x {N_COLS} float64, "
        f"{X.nbytes / 1e9:.1f} GB")
    torch.cuda.empty_cache()
    total, avail = _host_memory_gb()
    say(f"  host memory {total:.1f} GB, {avail:.1f} GB available with the float64 rows held")
    _small_path_reference(float32_inputs=False)
    data = {"features": X}
    kt = D._DEFAULT_K_TILE
    blocks = -(-N_ROWS // kt)
    timings, counts = {}, {}

    def counted(run, fn):
        """fn() with the counters set to 0 just before and read just after."""
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        timings[f"{run}_s"] = time.perf_counter() - t0
        counts[run] = dict(_kernels.launches)
        return out

    def only(run, allowed):
        """The run launched each form in `allowed` and no other form."""
        got = {k_: v for k_, v in counts[run].items() if v}
        if set(got) != set(allowed):
            fail(f"{run}: launched {got}, expected exactly {sorted(allowed)}")

    # KMeans: fit, transform, save / load
    def fit():
        return KMeans(k=K, maxIter=F64_MAX_ITER, tol=1e-20, initMode="random", seed=1,
                      float32_inputs=False).setFeaturesCol("features").fit(data)

    model = counted("fit", fit)
    only("fit", {"assign_argmin/f64", "assign_accumulate/f64"})
    if (model.cluster_centers_.shape != (K, N_COLS) or model.cluster_centers_.dtype != np.float64
            or not np.isfinite(model.cluster_centers_).all() or not np.isfinite(model.inertia_)):
        fail("float64 fit: centers or inertia not finite float64 of shape (1000, 3000)")
    pred = counted("transform", lambda: np.asarray(model.transform(data)["prediction"]))
    only("transform", {"assign_argmin/f64"})
    if pred.shape != (N_ROWS,) or pred.min() < 0 or pred.max() >= K:
        fail("float64 transform: predictions out of range")
    path = ROOT / "build" / "chip_smoke_model_f64"
    model.write().overwrite().save(str(path))
    loaded = KMeansModel.load(str(path))
    if loaded.float32_inputs:
        fail("float64 save/load: the loaded model lost float32_inputs=False")
    pred2 = counted("loaded_transform", lambda: np.asarray(loaded.transform(data)["prediction"]))
    only("loaded_transform", {"assign_argmin/f64"})
    if not np.array_equal(pred, pred2):
        fail("float64 save/load: the loaded model predicts differently")
    say(f"  fit (random init, {F64_MAX_ITER} iterations, high): {timings['fit_s']:.2f} s wall, n_iter_ "
        f"{model.n_iter_}, inertia {model.inertia_:.9e}; transform of {N_ROWS} rows {timings['transform_s']:.2f} "
        f"s wall; save/load keeps float32_inputs=False and the predictions")

    # the same fit through the plain versions on the card: the same
    # assignments, so the same n_iter_, and centers and inertia that differ
    # only by float64 summation order (sums of up to ~10^4 rows: relative
    # error below 10^4 x 2^-53, about 1e-12); held to 1e-9, 10^4 times
    # tighter than phase 3's float32 1e-5 and 1e-4
    with _plain_kernels():
        t0 = time.perf_counter()
        plain = fit()
        timings["plain_fit_s"] = time.perf_counter() - t0
    if plain.n_iter_ != model.n_iter_:
        fail(f"float64 fit: n_iter_ {model.n_iter_} through the kernels, {plain.n_iter_} plain")
    c_err = float(np.abs(model.cluster_centers_ - plain.cluster_centers_).max())
    c_scale = float(np.abs(plain.cluster_centers_).max())
    if c_err > 1e-9 * c_scale:
        fail(f"float64 fit: centers differ from the plain fit's by {c_err} > 1e-9 x {c_scale}")
    if abs(model.inertia_ - plain.inertia_) > 1e-9 * abs(plain.inertia_):
        fail(f"float64 fit: inertia {model.inertia_} against the plain fit's {plain.inertia_}")
    say(f"  the same fit through the plain versions on the card ({timings['plain_fit_s']:.2f} s): n_iter_ "
        f"equal, centers within {c_err:.3g} (1e-9 x {c_scale:.4g}), inertia {plain.inertia_:.9e}")
    del plain

    # exact kNN
    knn = NearestNeighbors(k=KNN_K, float32_inputs=False).setInputCol("features").fit(data)
    _, _, knn_df = counted("kneighbors", lambda: knn.kneighbors({"features": X[:KNN_QUERIES]}))
    only("kneighbors", {"d2_block/f64"})
    expected = blocks * -(-KNN_QUERIES // D.tile_rows())
    if counts["kneighbors"]["d2_block/f64"] != expected:
        fail(f"float64 kneighbors: d2_block/f64 launched {counts['kneighbors']['d2_block/f64']} times, "
             f"expected {expected}")
    idx = np.stack(knn_df["indices"].to_numpy())
    dist = np.stack(knn_df["distances"].to_numpy())
    if idx.shape != (KNN_QUERIES, KNN_K) or not np.isfinite(dist).all() or (np.diff(dist, axis=1) < 0).any():
        fail("float64 kneighbors: indices or distances malformed, not finite or not ascending")
    if not np.array_equal(idx[:, 0], np.arange(KNN_QUERIES)):
        fail(f"float64 kneighbors: {int((idx[:, 0] != np.arange(KNN_QUERIES)).sum())} queries do not find "
             "themselves first")
    # ||q||^2 - 2 q.q + ||q||^2: three float64 sums of d terms, each within
    # d 2^-53 ||q||^2 of the exact one, so about (4 d + 4) 2^-53 ||q||^2
    q_sq = np.sum(X[:KNN_QUERIES] ** 2, axis=1)
    self_tol = np.sqrt((4 * N_COLS + 4) * 2.0 ** -53 * q_sq)
    if (dist[:, 0] > self_tol).any():
        fail(f"float64 kneighbors: a self-distance exceeds the float64 bound: max {dist[:, 0].max()}")
    say(f"  kneighbors of {KNN_QUERIES} queries, k = {KNN_K}: {timings['kneighbors_s']:.2f} s wall, "
        f"{expected} d2_block/f64 launches; every query finds itself first (self-distance max "
        f"{dist[:, 0].max():.3g}, bound {self_tol.min():.3g} or more)")

    # one Lloyd iteration (high) on the resident rows, kernels and plain
    # (placed after kneighbors: its copy of the items and their norms'
    # temporary are gone by now)
    Xd, wd = place_rows(X, device=dev)
    cd = torch.from_numpy(model.cluster_centers_).to(dev)
    for route in ("kernels", "plain"):
        for _ in range(2):  # a warm-up, then the timed one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _plain_kernels() if route == "plain" else contextlib.nullcontext():
                float(_lloyd_step(Xd, wd, cd, TILE_ROWS, False)[2])
            dt = time.perf_counter() - t0
        timings[f"lloyd_iter_{route}_ms"] = dt * 1e3
    say(f"  one Lloyd iteration (high, float64) on resident rows: kernels {timings['lloyd_iter_kernels_ms']:.1f} "
        f"ms, plain {timings['lloyd_iter_plain_ms']:.1f} ms")
    del cd

    # the kernel route against the plain route on the same resident rows
    Q = Xd[:KNN_QUERIES]
    res, secs = _knn_routes(Xd, wd > 0, Q, KNN_K)
    (dk, ik), (dp, ip) = res["kernel"], res["plain"]
    d2k, d2p = dk ** 2, dp ** 2
    tol = f64_bound(N_COLS, Q, Xd, float(d2p.max()))
    err = float(np.abs(d2k - d2p).max())
    if err > tol:
        fail(f"float64 exact_knn: kernel and plain squared distances differ by {err} > the float64 bound {tol}")
    swapped = np.argwhere(ik != ip)
    if len(swapped):
        r, j = swapped[:, 0], swapped[:, 1]
        qd = Q[torch.from_numpy(r).to(dev)]
        xd = Xd[torch.from_numpy(ik[r, j].astype(np.int64)).to(dev)]
        exact = ((qd - xd) ** 2).sum(1).cpu().numpy()
        if (np.abs(exact - d2p[r, j]) > tol).any():
            fail(f"float64 exact_knn: {int((np.abs(exact - d2p[r, j]) > tol).sum())} index swaps are not "
                 "near-ties within the float64 bound")
    timings["exact_knn_kernel_s"], timings["exact_knn_plain_s"] = secs["kernel"], secs["plain"]
    say(f"  exact_knn on resident items: kernel route {', '.join(f'{t:.3f}' for t in secs['kernel'])} s, plain "
        f"route {', '.join(f'{t:.3f}' for t in secs['plain'])} s; squared distances within {err:.3g} "
        f"(float64 bound {tol:.3g}), {len(swapped)} of {ik.size} index positions differ, all near-ties")
    del Xd, wd, Q, res
    torch.cuda.empty_cache()  # only the served copy of the items stays

    # serving: the float64 KMeansModel as float64 and as bf16, the float64
    # kNN model as float64
    loads = (("kmeans_f64", model, "float64"), ("kmeans_f64_bf16", model, "bf16"),
             ("knn_f64", knn, "float64"))
    registry = ModelRegistry()
    dispatches = {}

    def serve():
        for name, m, serve_dtype in loads:
            t0 = time.perf_counter()
            entry = registry.load(name, m, serve_dtype=serve_dtype)
            torch.cuda.synchronize()
            timings[f"load_{name}_s"] = time.perf_counter() - t0
            real = entry.program.dispatch
            dispatches[name] = 0

            def dispatch(xb, _real=real, _name=name):
                dispatches[_name] += 1
                return _real(xb)

            entry.program.dispatch = dispatch
        rungs = registry.get("knn_f64").prewarmed_rungs
        engine = ScoringEngine(registry).start()
        futures = [[] for _ in traffic]

        def client(t):
            for lo, n in traffic[t]:
                futures[t].append([engine.submit(name, X[lo:lo + n], tenant=name) for name, _, _ in loads])

        threads = [threading.Thread(target=client, args=(t,)) for t in range(len(traffic))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        results = [[[f.result(timeout=600) for f in per_req] for per_req in fut] for fut in futures]
        timings["traffic_s"] = time.perf_counter() - t0
        timings["serve_stats"] = engine.stats()
        engine.stop()
        return rungs, results

    traffic = _serve_traffic(2027, F64_SERVE_CLIENTS, F64_SERVE_REQUESTS)
    telemetry.registry().reset()  # the engine's latency and batch figures
    telemetry.enable()
    rungs, results = counted("serving", serve)
    telemetry.disable()
    only("serving", {"assign_argmin/f64", "assign_argmin/f64-fast", "d2_block/f64"})
    want = blocks * (rungs + dispatches["knn_f64"])
    if counts["serving"]["d2_block/f64"] != want:
        fail(f"float64 serving: d2_block/f64 launched {counts['serving']['d2_block/f64']} times, expected "
             f"{want} ({blocks} item blocks x {rungs + dispatches['knn_f64']} kNN dispatches)")
    stats = timings["serve_stats"]
    say(f"  serving loads: " + ", ".join(f"{name} {timings[f'load_{name}_s']:.2f} s" for name, _, _ in loads)
        + f"; traffic {F64_SERVE_CLIENTS} clients x {F64_SERVE_REQUESTS} requests to each: "
        f"{timings['traffic_s']:.2f} s wall, {stats['batches']} batches, {stats['coalesced_batches']} coalesced, "
        f"e2e p50 {stats['e2e_p50_s'] * 1e3:.1f} ms, p99 {stats['e2e_p99_s'] * 1e3:.1f} ms; dispatches {dispatches}")
    solo_engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
    flips = 0
    try:
        for t, reqs in enumerate(traffic):
            for (lo, n), got in zip(reqs, results[t]):
                for (name, _, _), g in zip(loads, got):
                    ref = solo_engine.score(name, X[lo:lo + n], timeout=600)
                    pairs = zip(g, ref) if isinstance(g, tuple) else [(g, ref)]
                    if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in pairs):
                        fail(f"float64 serving: {name} response to rows {lo}..{lo + n} differs from the same "
                             "request served alone")
                km64, km16, (kd, ki) = got
                if not np.array_equal(km64, pred[lo:lo + n]):
                    fail(f"float64 serving: kmeans_f64 differs from KMeansModel.transform on rows {lo}..{lo + n}")
                flips += int((km16 != km64).sum())
                if ki.shape != (n, KNN_K) or not np.array_equal(ki[:, 0], np.arange(lo, lo + n)):
                    fail(f"float64 serving: a knn_f64 query among rows {lo}..{lo + n} does not find itself first")
    finally:
        solo_engine.stop()
    timings["kmeans_f64_bf16_flips"] = flips
    say(f"  every response equals the same request served alone, bit for bit; kmeans_f64 equals "
        f"KMeansModel.transform; kmeans_f64_bf16 assigns {flips} of "
        f"{sum(n for reqs in traffic for _, n in reqs)} rows differently; every knn_f64 query finds itself first")
    registry.clear()
    del knn
    counts["route"] = {key: sum(counts[run][key] for run in ("fit", "transform", "loaded_transform",
                                                             "kneighbors", "serving"))
                       for key in _kernels.launches}
    return counts, timings


# ------------------------------------------------------------ phase 7 ----

# PCA and LinearRegression (BASELINE.md's protocol rows): the PCA row, the
# three LinearRegression rows, the serving traffic of 7a, and the labels'
# seed and noise
PCA_K = 3
LINREG_CONFIGS = (
    ("ols", {"regParam": 0.0}),
    ("cd", {"regParam": 1e-5, "elasticNetParam": 0.5, "tol": 1e-30, "maxIter": 10}),
    ("ridge", {"regParam": 1e-5}),
)
LINREG_SERVE_CLIENTS, LINREG_SERVE_REQUESTS = 2, 4
LABEL_SEED, LABEL_NOISE = 2025, 0.1
# phase 7b's bounds on the float32 results against the float64 ones (PERF.md
# section 4): float32 eigh and LU backward errors of at most d 2^-24 of the
# matrix's norm, 2e-4 at d = 3000 (the float32 statistics' own error,
# about 1e-6 of the norm, is inside it)
F32_EIGH_REL = 2e-4
F32_SOLVE_REL = 2e-4


def _labels(X):
    """y = X·β + ε with β ~ N(0, 1/d) and ε ~ N(0, 0.1²), from a seed;
    returned with β."""
    rng = np.random.default_rng(LABEL_SEED)
    beta = (rng.standard_normal(X.shape[1]) / np.sqrt(X.shape[1])).astype(np.float32)
    y = X @ beta
    y += (rng.standard_normal(X.shape[0]) * LABEL_NOISE).astype(np.float32)
    return y, beta


def _dot_bound(x, m):
    """How far `rows_dot_fixed` (a pairwise tree of float32 adds, depth
    ceil(log2 d), after one float32 rounding of each product) may lie from
    the exact x·m: (ceil(log2 d) + 1) 2^-24 Σ|x_i m_i| per entry."""
    d = x.shape[1]
    depth = int(np.ceil(np.log2(d))) + 1
    return depth * 2.0 ** -24 * (np.abs(x).astype(np.float64) @ np.abs(m).astype(np.float64).T)


def _small_slice_reference():
    """PCA and LinearRegression on a small input, on the card and on the CPU
    (the same torch calls): the attributes, the solves' coefficients and the
    transforms agree to float32 rounding (components to 1e-4 on data with
    eigengaps of 4% of the largest eigenvalue); n_iter_ equal; on the card,
    a NaN row makes PCA raise SolverDivergedError and all-constant features
    give NaN coefficients, as on the CPU and in the JAX package."""
    from spark_rapids_ml_tpu_torch import PCA, LinearRegression, set_devices
    from spark_rapids_ml_tpu_torch.errors import SolverDivergedError

    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    x = ((rng.standard_normal((5000, 40)) * np.linspace(8.0, 1.0, 40)) @ q.T + 1.5).astype(np.float32)
    y = (x @ rng.standard_normal(40) + 0.3 + 0.05 * rng.standard_normal(5000)).astype(np.float32)
    data = {"features": x, "label": y}
    fits = {"pca": {}, "pca_bf16": {"solver_precision": "bf16"}, "ols": {}, "ridge": {"regParam": 0.01},
            "cd": {"regParam": 1e-3, "elasticNetParam": 0.5, "maxIter": 10, "tol": 1e-30},
            "ols_bf16": {"solver_precision": "bf16"}}
    results = {}
    for device in ("cpu", "cuda"):
        set_devices(device)
        out = {}
        for name, params in fits.items():
            if name.startswith("pca"):
                m = PCA(k=PCA_K, **params).setInputCol("features").setOutputCol("o").fit(data)
                out[name] = (m, np.stack(m.transform(data)["o"].to_numpy()))
            else:
                m = LinearRegression(**params).fit(data)
                out[name] = (m, np.asarray(m.transform(data)["prediction"]))
        bad = x[:500].copy()
        bad[7, 3] = np.nan
        try:
            PCA(k=PCA_K).setInputCol("features").fit({"features": bad})
            fail(f"small slice ({device}): a NaN row did not raise SolverDivergedError")
        except SolverDivergedError:
            pass
        const = np.tile(np.array([1.0, -2.0, 3.5], np.float32), (64, 1))
        out["constant"] = LinearRegression().fit({"features": const, "label": y[:64]})
        results[device] = out
    set_devices(None)
    cpu, gpu = results["cpu"], results["cuda"]
    for name in fits:
        (mc, tc), (mg, tg) = cpu[name], gpu[name]
        if name.startswith("pca"):
            scale = float(mc.explained_variance_[0])
            if np.abs(mg.explained_variance_ - mc.explained_variance_).max() > 1e-5 * scale:
                fail(f"small slice: {name} explained variance differs between the card and the CPU")
            if np.abs(mg.components_ - mc.components_).max() > 1e-4:
                fail(f"small slice: {name} components differ between the card and the CPU beyond 1e-4")
        else:
            scale = float(np.abs(mc.coef_).max())
            if np.abs(mg.coef_ - mc.coef_).max() > 1e-4 * scale or abs(mg.intercept_ - mc.intercept_) > 1e-4 * scale:
                fail(f"small slice: {name} coefficients differ between the card and the CPU beyond rtol 1e-4")
            if mg.n_iter_ != mc.n_iter_:
                fail(f"small slice: {name} n_iter_ {mg.n_iter_} on the card, {mc.n_iter_} on the CPU")
        if np.abs(tg - tc).max() > 1e-4 * float(np.abs(tc).max()):
            fail(f"small slice: {name} transform differs between the card and the CPU")
    if not (np.isnan(gpu["constant"].coef_).all() and np.isnan(cpu["constant"].coef_).all()):
        fail("small slice: all-constant features did not give NaN coefficients on the card and the CPU")
    say(f"  small slice, 5000 x 40 ({', '.join(fits)}): card and CPU agree; cd n_iter_ {gpu['cd'][0].n_iter_}; "
        "a NaN row raises SolverDivergedError and all-constant features give NaN coefficients on the card")


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_pca_linear(dev, X):
    """Phase 7a: PCA(k=3) and BASELINE.md's three LinearRegression
    configurations through the public API on the protocol rows (float32),
    with their bf16 fits, save/load, the fit's parts timed on resident rows,
    and one ModelRegistry serving the PCA and the OLS model. Returns
    (what 7b compares with, timings)."""
    import threading

    import torch

    from spark_rapids_ml_tpu_torch import (LinearRegression, LinearRegressionModel, ModelRegistry, PCA, PCAModel,
                                           ScoringEngine, telemetry)
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import linalg as L
    from spark_rapids_ml_tpu_torch.ops import linear as LR
    from spark_rapids_ml_tpu_torch.ops import pca as P
    from spark_rapids_ml_tpu_torch.parallel import host_tensor, place_rows

    say(f"phase 7a: PCA(k={PCA_K}) and LinearRegression, {N_ROWS} x {N_COLS} float32")
    _small_slice_reference()
    timings = {}
    (y, beta), timings["labels_s"] = _timed(lambda: _labels(X))
    data = {"features": X, "label": y}
    ref_rows = X[:KNN_QUERIES]
    _kernels.reset_launches()

    tdata = {"features": X[:TRANSFORM_ROWS]}

    def transform_pca(model):
        return np.stack(model.transform(tdata)["pcs"].to_numpy())

    # PCA: fit, transform, save / load, bf16
    pca, timings["pca_fit_s"] = _timed(lambda: PCA(k=PCA_K).setInputCol("features").setOutputCol("pcs").fit(data))
    comps, ev = pca.components_, pca.explained_variance_
    if comps.shape != (PCA_K, N_COLS) or not np.isfinite(comps).all() or not np.isfinite(ev).all():
        fail("PCA fit: components or variances not finite of shape (3, 3000)")
    gram_err = float(np.abs(comps.astype(np.float64) @ comps.T.astype(np.float64) - np.eye(PCA_K)).max())
    if gram_err > 1e-5 or (np.diff(ev) > 0).any() or not (0 < pca.explained_variance_ratio_.sum() < 1):
        fail(f"PCA fit: components not orthonormal ({gram_err}) or variances not descending ratios")
    proj, timings["pca_transform_s"] = _timed(lambda: transform_pca(pca))
    if proj.shape != (TRANSFORM_ROWS, PCA_K) or not np.isfinite(proj).all():
        fail("PCA transform: not finite of shape (1000000, 3)")
    exact = ref_rows.astype(np.float64) @ comps.T.astype(np.float64)
    err = np.abs(proj[:KNN_QUERIES] - exact)
    bound = _dot_bound(ref_rows, comps)
    if (err > bound).any():
        fail(f"PCA transform: {int((err > bound).sum())} entries of the first {KNN_QUERIES} rows lie beyond the "
             f"float32 bound from X @ components.T (max {err.max()})")
    path = ROOT / "build" / "chip_smoke_pca"
    pca.write().overwrite().save(str(path))
    if not np.array_equal(transform_pca(PCAModel.load(str(path))), proj):
        fail("PCA save/load: the loaded model's transform differs from the fitted model's")
    pca16, timings["pca_bf16_fit_s"] = _timed(
        lambda: PCA(k=PCA_K, solver_precision="bf16").setInputCol("features").setOutputCol("pcs").fit(data))
    ev_err = float(np.abs(pca16.explained_variance_ / ev - 1).max())
    c_err = float(np.abs(np.abs(pca16.components_) - np.abs(comps)).max())
    if ev_err > 2e-3 or c_err > 5e-3:
        fail(f"PCA bf16 fit: explained variance off by rtol {ev_err} (bound 2e-3) or |components| by {c_err} "
             "(bound 5e-3)")
    say(f"  PCA fit {timings['pca_fit_s']:.2f} s wall, explained variance {ev.tolist()}, ratio "
        f"{pca.explained_variance_ratio_.tolist()}; transform of {TRANSFORM_ROWS} rows {timings['pca_transform_s']:.2f} s "
        f"wall, the first {KNN_QUERIES} within the float32 bound of X @ components.T (max {err.max():.3g}); "
        f"save/load bit for bit; bf16 fit {timings['pca_bf16_fit_s']:.2f} s, explained variance within rtol "
        f"{ev_err:.3g}, |components| within {c_err:.3g}")

    # LinearRegression: BASELINE.md's three configurations, then bf16 OLS
    models, preds = {}, {}
    for name, params in LINREG_CONFIGS:
        m, timings[f"{name}_fit_s"] = _timed(lambda: LinearRegression(**params).fit(data))
        if m.coef_.shape != (N_COLS,) or not np.isfinite(m.coef_).all() or not np.isfinite(m.intercept_):
            fail(f"{name} fit: coefficients not finite of shape (3000,)")
        if name == "cd" and m.n_iter_ != params["maxIter"]:
            fail(f"cd fit: n_iter_ {m.n_iter_}, expected {params['maxIter']} sweeps at tol 1e-30")
        pred, timings[f"{name}_transform_s"] = _timed(lambda: np.asarray(m.transform(tdata)["prediction"]))
        exact = ref_rows.astype(np.float64) @ m.coef_.astype(np.float64) + m.intercept_
        bound = _dot_bound(ref_rows, m.coef_[None, :])[:, 0] + 2.0 ** -23 * (np.abs(exact) + abs(m.intercept_))
        if pred.shape != (TRANSFORM_ROWS,) or (np.abs(pred[:KNN_QUERIES] - exact) > bound).any():
            fail(f"{name} transform: beyond the float32 bound from X @ coef + intercept")
        path = ROOT / "build" / f"chip_smoke_linreg_{name}"
        m.write().overwrite().save(str(path))
        if not np.array_equal(np.asarray(LinearRegressionModel.load(str(path)).transform(tdata)["prediction"]), pred):
            fail(f"{name} save/load: the loaded model's transform differs from the fitted model's")
        rmse = float(np.sqrt(np.mean((pred[:KNN_QUERIES] - y[:KNN_QUERIES]) ** 2)))
        coef_err = float(np.abs(m.coef_ - beta).max())
        if name == "cd":
            # 10 sweeps of coordinate descent stop far from the optimum on
            # these correlated columns: the fit must only beat the mean
            if not rmse < 0.5 * float(np.std(y[:KNN_QUERIES])):
                fail(f"cd fit: residual RMS {rmse} not below half the labels' spread")
        elif not (0.9 * LABEL_NOISE < rmse < 1.1 * LABEL_NOISE) or coef_err > 5e-3:
            # converged solves recover beta: the residual is the noise
            fail(f"{name} fit: residual RMS {rmse} on the first rows (noise {LABEL_NOISE}) or max |coef - beta| "
                 f"{coef_err} out of range")
        models[name], preds[name] = m, pred
        say(f"  {name} {params}: fit {timings[f'{name}_fit_s']:.2f} s wall, n_iter_ {m.n_iter_}, intercept "
            f"{m.intercept_:.6g}, max |coef - beta| {coef_err:.3g}, residual RMS {rmse:.5f}; transform "
            f"{timings[f'{name}_transform_s']:.2f} s wall, within the float32 bound; save/load bit for bit")
    ols16, timings["ols_bf16_fit_s"] = _timed(lambda: LinearRegression(solver_precision="bf16").fit(data))
    ols = models["ols"]
    if not (np.allclose(ols16.coef_, ols.coef_, rtol=5e-3, atol=5e-4)
            and abs(ols16.intercept_ - ols.intercept_) <= 5e-3):
        fail(f"ols bf16 fit: coefficients beyond rtol 5e-3 / atol 5e-4 of the float32 fit (max "
             f"{np.abs(ols16.coef_ - ols.coef_).max()}) or intercept beyond 5e-3")
    say(f"  ols bf16 fit {timings['ols_bf16_fit_s']:.2f} s wall: coefficients within "
        f"{np.abs(ols16.coef_ - ols.coef_).max():.3g} of the float32 fit, intercept within "
        f"{abs(ols16.intercept_ - ols.intercept_):.3g}")
    launches = {k_: v for k_, v in _kernels.launches.items() if v}
    say(f"  kernel launches in phase 7a's fits and transforms: {launches or 'none'} (no kernel on this path)")

    # the fit's parts on resident rows: placement, statistics, eigh / solve
    (Xd, wd), timings["place_rows_s"] = _timed(lambda: place_rows(X, device=dev))
    yd = host_tensor(y).to(dev)
    for fast in (False, True):
        tag = "_bf16" if fast else ""
        (tw, mean, cov), timings[f"pca_stats{tag}_s"] = _timed(lambda: L.weighted_cov(Xd, wd, fast=fast))
        stats, timings[f"linear_stats{tag}_s"] = _timed(lambda: LR._sufficient_stats(Xd, yd, wd, fast))
    (evals, _), timings["eigh_s"] = _timed(lambda: torch.linalg.eigh(cov))
    _, timings["pca_finish_s"] = _timed(lambda: P._pca_finish(tw, mean, cov, k=PCA_K))
    spectrum = evals.double().flip(0).cpu().numpy()
    # each solve on the card, and from the same statistics on the CPU: the
    # same arithmetic but for the LU's and the reductions' rounding, held to
    # the normwise bound of phase 7b (condition number x backward error)
    kappa = float(spectrum[0] / spectrum[-1])
    rel = kappa * F32_SOLVE_REL / (1 - kappa * F32_SOLVE_REL)
    stats, _ = _timed(lambda: LR._sufficient_stats(Xd, yd, wd, False))
    stats_cpu = tuple(t.cpu() for t in stats)
    same = {}
    for name, params in LINREG_CONFIGS:
        kw = dict(alpha=params["regParam"], l1_ratio=params.get("elasticNetParam", 0.0), fit_intercept=True,
                  standardize=True, max_iter=params.get("maxIter", 100), tol=params.get("tol", 1e-6))
        kw["use_cd"] = kw["alpha"] > 0 and kw["l1_ratio"] > 0
        state, timings[f"{name}_solve_s"] = _timed(lambda: LR._solve_from_stats(stats, Xd.dtype, **kw))
        host = LR._solve_from_stats(stats_cpu, Xd.dtype, **kw)
        card_coef, host_coef = state["coef_"].cpu().numpy(), host["coef_"].numpy()
        err = float(np.linalg.norm(card_coef - host_coef) / np.linalg.norm(host_coef))
        if err > rel or int(state["n_iter_"]) != int(host["n_iter_"]):
            fail(f"{name} solve: the card's coefficients lie {err} (relative) from the CPU's on the same "
                 f"statistics (bound {rel}), or n_iter_ differs")
        same[name] = "bit for bit" if np.array_equal(card_coef, host_coef) else f"within {err:.3g}"
        if kw["use_cd"]:
            timings["cd_sweep_ms"] = timings[f"{name}_solve_s"] * 1e3 / int(state["n_iter_"])
    del Xd, wd, yd, stats, cov
    torch.cuda.empty_cache()
    say(f"  fit parts on resident rows: placing X {timings['place_rows_s']:.3f} s; statistics pass PCA "
        f"{timings['pca_stats_s']:.3f} s (bf16 {timings['pca_stats_bf16_s']:.3f}), linear "
        f"{timings['linear_stats_s']:.3f} s (bf16 {timings['linear_stats_bf16_s']:.3f}; bf16 products through "
        f"torch.mm(bf16, bf16, out_dtype=torch.float32)); eigh of {N_COLS} x {N_COLS} {timings['eigh_s']:.3f} s, "
        f"the whole PCA finish {timings['pca_finish_s']:.3f} s; solves ols {timings['ols_solve_s']:.3f} s, ridge "
        f"{timings['ridge_solve_s']:.3f} s, cd {timings['cd_solve_s']:.3f} s = {timings['cd_sweep_ms']:.1f} ms "
        f"per sweep; covariance spectrum top {spectrum[:5].tolist()}, smallest {spectrum[-1]:.6g}; each solve "
        f"equals the CPU's on the same statistics: {same} (bound {rel:.3g})")

    # serving: PCA and OLS in one registry, coalesced = solo = transform
    registry = ModelRegistry()
    loads = (("pca", pca, proj), ("ols", ols, preds["ols"]))
    for name, m, _ in loads:
        _, timings[f"load_{name}_s"] = _timed(lambda: registry.load(name, m))
    traffic = _serve_traffic(2029, LINREG_SERVE_CLIENTS, LINREG_SERVE_REQUESTS, TRANSFORM_ROWS)
    telemetry.registry().reset()
    telemetry.enable()
    engine = ScoringEngine(registry).start()
    futures = [[] for _ in traffic]

    def client(t):
        for lo, n in traffic[t]:
            futures[t].append([engine.submit(name, X[lo:lo + n], tenant=name) for name, _, _ in loads])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(len(traffic))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = [[[f.result(timeout=600) for f in per_req] for per_req in fut] for fut in futures]
    timings["traffic_s"] = time.perf_counter() - t0
    stats = engine.stats()
    engine.stop()
    telemetry.disable()
    solo_engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
    try:
        for t, reqs in enumerate(traffic):
            for (lo, n), got in zip(reqs, results[t]):
                for (name, _, whole), g in zip(loads, got):
                    ref = solo_engine.score(name, X[lo:lo + n], timeout=600)
                    if not (g.dtype == ref.dtype and np.array_equal(g, ref)):
                        fail(f"serving: {name} response to rows {lo}..{lo + n} differs from the same request "
                             "served alone")
                    if not np.array_equal(g, whole[lo:lo + n]):
                        fail(f"serving: {name} response to rows {lo}..{lo + n} differs from its model's transform")
    finally:
        solo_engine.stop()
    registry.clear()
    say(f"  serving loads pca {timings['load_pca_s']:.2f} s, ols {timings['load_ols_s']:.2f} s; traffic "
        f"{LINREG_SERVE_CLIENTS} clients x {LINREG_SERVE_REQUESTS} requests to each: {timings['traffic_s']:.2f} s "
        f"wall, {stats['batches']} batches, {stats['coalesced_batches']} coalesced, e2e p50 "
        f"{stats['e2e_p50_s'] * 1e3:.1f} ms, p99 {stats['e2e_p99_s'] * 1e3:.1f} ms; every response equals the "
        "same request served alone and the model's transform, bit for bit")
    timings["serve_stats"] = stats
    torch.cuda.empty_cache()
    return {"pca": pca, "ols": ols, "y": y, "spectrum": spectrum}, timings


def phase_pca_linear_f64(dev, X64, ref):
    """Phase 7b: PCA(k=3) and OLS with float32_inputs=False on the float64
    rows, and 7a's float32 results held to them within the bounds of
    PERF.md section 4 (F32_EIGH_REL, F32_SOLVE_REL); a NaN row raises
    SolverDivergedError on the card in float64 too."""
    from spark_rapids_ml_tpu_torch import PCA, LinearRegression
    from spark_rapids_ml_tpu_torch.errors import SolverDivergedError

    say("phase 7b: PCA and OLS with float32_inputs=False, held to phase 7a's float32 results")
    timings = {}
    pca32, ols32, spectrum = ref["pca"], ref["ols"], ref["spectrum"]
    pca64, timings["pca_fit_s"] = _timed(
        lambda: PCA(k=PCA_K, float32_inputs=False).setInputCol("features").fit({"features": X64}))
    if pca64.components_.dtype != np.float64:
        fail("float64 PCA fit: components are not float64")
    # Weyl: each eigenvalue moves by at most the perturbation's norm,
    # bounded by F32_EIGH_REL of the largest eigenvalue
    lam1 = float(pca64.explained_variance_[0])
    pert = F32_EIGH_REL * lam1
    ev_err = float(np.abs(pca32.explained_variance_ - pca64.explained_variance_).max())
    ratio_err = float(np.abs(pca32.explained_variance_ratio_ - pca64.explained_variance_ratio_).max())
    if ev_err > pert or ratio_err > 2 * F32_EIGH_REL * float(pca64.explained_variance_ratio_[0]):
        fail(f"7b: float32 explained variance off by {ev_err} (bound {pert}) or ratio by {ratio_err}")
    # Davis-Kahan: sin(angle) <= perturbation / gap, the gap from 7a's
    # float32 spectrum less twice the perturbation
    cosines, checked = [], []
    for i in range(PCA_K):
        gap = min(abs(spectrum[i] - spectrum[j]) for j in range(PCA_K + 1) if j != i) - 2 * pert
        cos = abs(float(pca32.components_[i].astype(np.float64) @ pca64.components_[i]))
        cosines.append(cos)
        if gap > 0 and pert / gap < 1:
            checked.append(i)
            if cos < np.sqrt(1 - (pert / gap) ** 2):
                fail(f"7b: component {i}: |cos| {cos} against the float64 one, below the Davis-Kahan bound "
                     f"{np.sqrt(1 - (pert / gap) ** 2)} (gap {gap})")
    ols64, timings["ols_fit_s"] = _timed(
        lambda: LinearRegression(float32_inputs=False).fit({"features": X64, "label": ref["y"].astype(np.float64)}))
    # the normwise forward error of a solve: condition number x backward
    # error, the condition number that of the covariance (7a's spectrum)
    kappa = float(spectrum[0] / spectrum[-1])
    rel = kappa * F32_SOLVE_REL / (1 - kappa * F32_SOLVE_REL)
    c_err = float(np.linalg.norm(ols32.coef_ - ols64.coef_) / np.linalg.norm(ols64.coef_))
    i_bound = float(np.linalg.norm(pca64.mean_)) * rel * float(np.linalg.norm(ols64.coef_)) + 1e-6
    i_err = abs(ols32.intercept_ - ols64.intercept_)
    if c_err > rel or i_err > i_bound:
        fail(f"7b: float32 OLS coefficients off by {c_err} (bound {rel}) or intercept by {i_err} (bound {i_bound})")
    bad = X64[:4096].copy()
    bad[5, 9] = np.nan
    try:
        PCA(k=PCA_K, float32_inputs=False).setInputCol("features").fit({"features": bad})
        fail("7b: a NaN row did not raise SolverDivergedError in a float64 PCA fit on the card")
    except SolverDivergedError:
        pass
    say(f"  PCA fit {timings['pca_fit_s']:.2f} s, OLS fit {timings['ols_fit_s']:.2f} s wall (float64); float32 "
        f"against float64: explained variance within {ev_err:.3g} (bound {pert:.3g}), ratio within {ratio_err:.3g}; "
        f"|cos| {[round(c, 9) for c in cosines]} (held to the bound for components {checked}); OLS coefficients "
        f"within {c_err:.3g} relative (bound {rel:.3g}, condition {kappa:.4g}), intercept within {i_err:.3g} "
        f"(bound {i_bound:.3g}); a NaN row raises SolverDivergedError")
    return timings


# LogisticRegression (BASELINE.md's LogisticRegression row: maxIter=200,
# tol=1e-30, regParam=1e-5 on 1M x 3000): that row, its bf16 fit, two
# elastic nets (OWL-QN) and a multinomial fit (k = 4), the last three cut to
# 50 iterations for time; the labels' seed and noise; the serving traffic.
# The first elastic net is that row's regParam with elasticNetParam 0.5: its
# L1 weight, 5e-6, lies far below the gradient's sampling noise at 1M rows
# (~1e-3), so its optimum need have no exact zero; the second, at regParam
# 1e-2 (L1 weight 5e-3), is the one held to having exact zeros
LOGREG_ROW = {"maxIter": 200, "tol": 1e-30, "regParam": 1e-5}
LOGREG_CONFIGS = (
    ("baseline", LOGREG_ROW, 2),
    ("bf16", dict(LOGREG_ROW, solver_precision="bf16"), 2),
    ("enet", dict(LOGREG_ROW, elasticNetParam=0.5, maxIter=50), 2),
    ("enet_sparse", dict(LOGREG_ROW, regParam=1e-2, elasticNetParam=0.5, maxIter=50), 2),
    ("multinomial", dict(LOGREG_ROW, maxIter=50), 4),
)
LOGREG_LABEL_SEED, LOGREG_NOISE = 2026, 0.5
LOGREG_SERVE_CLIENTS, LOGREG_SERVE_REQUESTS = 2, 4
# unit roundoffs: bf16 (8 significant bits) and float32
BF16_U, F32_U = 2.0 ** -9, 2.0 ** -24


def _class_labels(X, k):
    """y = argmax([0, X·β + 0.5·ε]) with β ~ N(0, 1/d) of k − 1 columns and
    ε ~ N(0, 1), from a seed (benchmark/gen_data.py's classification
    labels), as float32 class indices."""
    rng = np.random.default_rng(LOGREG_LABEL_SEED + k)
    beta = (rng.standard_normal((X.shape[1], k - 1)) / np.sqrt(X.shape[1])).astype(np.float32)
    s = X @ beta
    s += LOGREG_NOISE * rng.standard_normal(s.shape, dtype=np.float32)
    return np.argmax(np.concatenate([np.zeros((len(X), 1), np.float32), s], axis=1), axis=1).astype(np.float32)


@contextlib.contextmanager
def _counting_syncs():
    """Counts the calls that make the host wait for the card while the body
    runs (torch.cuda.set_sync_debug_mode's warnings): {"n": count}."""
    import warnings

    import torch

    box = {"n": 0}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield box
        box["n"] = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _small_logreg_reference():
    """The four solver branches (binomial and multinomial, L2 and elastic
    net) through the public API on a small float64 input, on the card and
    on the CPU: 10 iterations each (tol = 0, so maxIter alone stops them);
    n_iter_ equal, coefficients within 1e-9 of the largest, objectives to
    rtol 1e-12 (the same float64 arithmetic summed in another order, its
    rounding carried through 10 iterations)."""
    from spark_rapids_ml_tpu_torch import LogisticRegression, set_devices

    rng = np.random.default_rng(13)
    x = rng.standard_normal((4000, 30)) * rng.uniform(0.5, 3.0, 30) + rng.uniform(-2.0, 2.0, 30)
    scores = x @ (rng.standard_normal((30, 2)) / np.sqrt(30.0)) + 0.5 * rng.standard_normal((4000, 2))
    labels = {2: (scores[:, 0] > 0).astype(np.float64),
              3: np.argmax(np.concatenate([np.zeros((4000, 1)), scores], axis=1), axis=1).astype(np.float64)}
    fits = {"binomial_l2": ({"regParam": 0.01}, 2), "binomial_enet": ({"regParam": 0.01, "elasticNetParam": 0.5}, 2),
            "multinomial_l2": ({"regParam": 0.01}, 3),
            "multinomial_enet": ({"regParam": 0.01, "elasticNetParam": 0.5}, 3)}
    results = {}
    for device in ("cpu", "cuda"):
        set_devices(device)
        results[device] = {
            name: LogisticRegression(maxIter=10, tol=0.0, float32_inputs=False, **params).fit(
                {"features": x, "label": labels[k]})
            for name, (params, k) in fits.items()
        }
    set_devices(None)
    for name in fits:
        mc, mg = results["cpu"][name], results["cuda"][name]
        scale = float(np.abs(mc.coef_).max())
        if mg.n_iter_ != mc.n_iter_ or mg.n_iter_ != 10:
            fail(f"small LogReg slice: {name} n_iter_ {mg.n_iter_} on the card, {mc.n_iter_} on the CPU (want 10)")
        if (np.abs(mg.coef_ - mc.coef_).max() > 1e-9 * scale
                or np.abs(mg.intercept_ - mc.intercept_).max() > 1e-9 * max(scale, 1.0)
                or abs(mg.objective_ - mc.objective_) > 1e-12 * abs(mc.objective_)):
            fail(f"small LogReg slice: {name} differs between the card and the CPU (coef max diff "
                 f"{np.abs(mg.coef_ - mc.coef_).max()}, objective {mg.objective_} vs {mc.objective_})")
    worst = max(float(np.abs(results["cuda"][n].coef_ - results["cpu"][n].coef_).max()) for n in fits)
    say(f"  small slice, 4000 x 30 float64 ({', '.join(fits)}; 10 iterations each): card and CPU agree "
        f"(coefficients within {worst:.3g})")


def _flat_iterate(model, mu, d_scale, dtype):
    """A binomial model's (coef, intercept) as the solver's flat
    standardized iterate [B; b0] on the device (ops/logistic._warm_x0)."""
    from spark_rapids_ml_tpu_torch.ops import logistic as LG

    return LG._warm_x0((model.coef_, model.intercept_), model.n_cols, 1, mu, d_scale, True, dtype)


def _pair_ms(matvec, rmat, b, r, itemsize):
    """One X·b + Xᵀ·r pair of a GLM iteration timed on the card, each
    product apart too, beside the pair's bound: X read twice over the
    memory rate."""
    return {"pair_ms": cuda_ms(lambda: (matvec(b), rmat(r))), "matvec_ms": cuda_ms(lambda: matvec(b)),
            "rmat_ms": cuda_ms(lambda: rmat(r)), "pair_bound_ms": 2 * N_ROWS * N_COLS * itemsize / PEAK_BYTES_S * 1e3}


def _glm_eigs(Xd, wd, xf, mu, d_scale, total_w, lam_l2):
    """Smallest and largest eigenvalue of the binomial objective's Hessian in
    the solver's flat coordinates [B; b0] at the flat iterate xf:
    (1/Σw) Σ wᵢ pᵢ(1 − pᵢ) [x̃ᵢ; 1][x̃ᵢ; 1]ᵀ + λ2 on the B block, with
    x̃ = (x − μ)·d_scale; summed over row tiles at X's dtype."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import linalg as L

    d = Xd.shape[1]
    B, b0 = xf[:d], xf[d:]
    acc = torch.zeros((d + 1, d + 1), dtype=Xd.dtype, device=Xd.device)
    for rows in L.row_tiles(Xd.shape[0]):
        xa = torch.cat([(Xd[rows] - mu) * d_scale, torch.ones_like(Xd[rows, :1])], dim=1)
        p = torch.sigmoid(xa[:, :d] @ B + b0)
        acc.addmm_((xa * (wd[rows] * p * (1 - p))[:, None]).T, xa)
    H = acc / total_w
    H[:d, :d] += lam_l2 * torch.eye(d, dtype=Xd.dtype, device=Xd.device)
    ev = torch.linalg.eigvalsh(H)
    return float(ev[0]), float(ev[-1])


def phase_logreg(dev, X):
    """Phase 8a: BASELINE.md's LogisticRegression row, its bf16 fit, an
    elastic net and a multinomial fit (k = 4) through the public API on the
    protocol rows (float32), with transform, save/load, the gates of
    PERF.md section 4, one ModelRegistry serving the binomial and the
    multinomial model, and the loops timed on resident rows. Returns (what
    8b compares with, timings)."""
    import threading

    import torch

    from spark_rapids_ml_tpu_torch import (LogisticRegression, LogisticRegressionModel, ModelRegistry, ScoringEngine,
                                           telemetry)
    from spark_rapids_ml_tpu_torch.errors import SolverDivergedError
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import logistic as LG
    from spark_rapids_ml_tpu_torch.parallel import host_tensor, place_rows

    say(f"phase 8a: LogisticRegression, {N_ROWS} x {N_COLS} float32")
    _small_logreg_reference()
    _kernels.reset_launches()
    timings = {}
    labels = {}
    for k in (2, 4):
        labels[k], timings[f"labels_k{k}_s"] = _timed(lambda: _class_labels(X, k))
    bad = X[:KNN_QUERIES].copy()
    bad[7, 3] = np.nan
    try:
        LogisticRegression().fit({"features": bad, "label": labels[2][:KNN_QUERIES]})
        fail("LogisticRegression: a NaN row did not raise SolverDivergedError on the card")
    except SolverDivergedError:
        pass
    ref_rows = X[:KNN_QUERIES].astype(np.float64)
    models, outs = {}, {}
    for name, params, k in LOGREG_CONFIGS:
        data = {"features": X, "label": labels[k]}
        m, timings[f"{name}_fit_s"] = _timed(lambda: LogisticRegression(**params).fit(data))
        k_out = 1 if k == 2 else k
        if (m.coef_.shape != (k_out, N_COLS) or not np.isfinite(m.coef_).all()
                or not np.isfinite(m.intercept_).all() or m.numClasses != k):
            fail(f"LogReg {name}: coefficients not finite of shape ({k_out}, {N_COLS})")
        models[name] = m
        if name in ("baseline", "multinomial"):
            out, timings[f"{name}_transform_s"] = _timed(lambda: m.transform({"features": X[:TRANSFORM_ROWS]}))
            raw = np.stack(out["rawPrediction"].to_numpy())
            prob = np.stack(out["probability"].to_numpy())
            pred = np.asarray(out["prediction"])
            if raw.shape != (TRANSFORM_ROWS, k) or prob.shape != (TRANSFORM_ROWS, k) or not np.isfinite(prob).all():
                fail(f"LogReg {name} transform: not finite of shape ({TRANSFORM_ROWS}, {k})")
            # the first rows' probabilities against float64 on the host: the
            # margins within the fixed-order dot's float32 bound, the link
            # moving a probability by at most half the margins' error
            z = ref_rows @ m.coef_.T + m.intercept_
            z_err = _dot_bound(X[:KNN_QUERIES], m.coef_) + 2.0 ** -23 * (np.abs(z) + np.abs(m.intercept_))
            if k == 2:
                z = np.concatenate([np.zeros_like(z), z], axis=1)
                z_err = np.concatenate([np.zeros_like(z_err), z_err], axis=1)
            e = np.exp(z - z.max(axis=1, keepdims=True))
            exact = e / e.sum(axis=1, keepdims=True)
            err = np.abs(prob[:KNN_QUERIES] - exact)
            bound = 0.5 * z_err.max(axis=1, keepdims=True) + 8 * F32_U
            if (err > bound).any():
                fail(f"LogReg {name} transform: {int((err > bound).sum())} probabilities of the first "
                     f"{KNN_QUERIES} rows beyond the float32 bound of the float64 computation (max {err.max()})")
            want = (prob[:, 1] > m.getThreshold()).astype(np.float64) if k == 2 else np.argmax(prob, axis=1)
            if not np.array_equal(pred, m.classes_[want.astype(int)]):
                fail(f"LogReg {name}: the prediction column is not the threshold / argmax of the probabilities")
            row_sums = np.abs(prob.sum(axis=1, dtype=np.float64) - 1.0).max()
            if row_sums > 8 * F32_U:
                fail(f"LogReg {name}: a row of probabilities sums to 1 ± {row_sums}")
            acc = float(np.mean(pred == labels[k][:TRANSFORM_ROWS]))
            outs[name] = (raw, prob)
            say(f"  {name} {params}: fit {timings[f'{name}_fit_s']:.2f} s wall, n_iter_ {m.n_iter_}, objective "
                f"{m.objective_:.9g}; transform {timings[f'{name}_transform_s']:.2f} s wall, the first {KNN_QUERIES} "
                f"rows within the float32 bound (max {err.max():.3g}), rows sum to 1 within {row_sums:.3g}, "
                f"training accuracy {acc:.4f}")
        else:
            say(f"  {name} {params}: fit {timings[f'{name}_fit_s']:.2f} s wall, n_iter_ {m.n_iter_}, objective "
                f"{m.objective_:.9g}")
        path = ROOT / "build" / f"chip_smoke_logreg_{name}"
        m.write().overwrite().save(str(path))
        loaded = LogisticRegressionModel.load(str(path))
        if not (np.array_equal(loaded.coef_, m.coef_) and np.array_equal(loaded.intercept_, m.intercept_)
                and all(np.array_equal(a, b) for a, b in zip(loaded._raw_prob(X[:KNN_QUERIES]),
                                                            m._raw_prob(X[:KNN_QUERIES])))):
            fail(f"LogReg {name} save/load: the loaded model differs from the fitted one")
    base, fast, multi = (models[n] for n in ("baseline", "bf16", "multinomial"))
    # elastic nets: at most the objective at 0 (ln 2: every logit 0, no
    # penalty); the one with the larger L1 weight has exact zeros
    zeros = {n: int((models[n].coef_ == 0).sum()) for n in ("enet", "enet_sparse")}
    for n in zeros:
        if not models[n].objective_ <= np.log(2.0):
            fail(f"LogReg {n}: objective {models[n].objective_} above its value at 0, {np.log(2.0)}")
    if zeros["enet_sparse"] == 0:
        fail("LogReg enet_sparse: no exact zero in the coefficients")
    # multinomial: centered intercepts
    i_sum = abs(float(multi.intercept_.sum()))
    if i_sum > 8 * F32_U * float(np.abs(multi.intercept_).sum()):
        fail(f"LogReg multinomial: intercepts sum to {i_sum}, not 0 within float32 rounding")
    launches = {k_: v for k_, v in _kernels.launches.items() if v}
    if launches:
        fail(f"LogReg: kernels launched on a path that has none: {launches}")
    say(f"  save/load bit for bit ({len(models)} models); exact zeros of {N_COLS}: {zeros}, objectives <= ln 2; "
        f"multinomial intercepts sum to {i_sum:.3g}; a NaN row raises "
        "SolverDivergedError; kernel launches: none")

    # the loops on resident rows: placement, the standardization pass, the
    # bf16 staging, ms per iteration, host reads, one X·b + Xᵀ·r pair
    (Xd, wd), timings["place_rows_s"] = _timed(lambda: place_rows(X, device=dev))
    y_idx = {k: host_tensor(labels[k].astype(np.int64)).to(dev) for k in (2, 4)}
    (mu, d_scale, total_w), timings["scaling_s"] = _timed(lambda: LG._make_scaling(Xd, wd, True, True))
    loops = {}
    for name, params, k in LOGREG_CONFIGS:
        fast_ = params.get("solver_precision") == "bf16"
        (matvec, rmat), timings[f"{name}_staging_s"] = _timed(lambda: LG._dense_ops(Xd, fast_))
        kw = dict(k=k, multinomial=k > 2, lam_l2=params["regParam"] * (1 - params.get("elasticNetParam", 0.0)),
                  lam_l1=params["regParam"] * params.get("elasticNetParam", 0.0),
                  use_l1=params.get("elasticNetParam", 0.0) > 0, fit_intercept=True,
                  max_iter=params["maxIter"], tol=params["tol"], lbfgs_memory=10)
        with _counting_syncs() as syncs:
            state, loop_s = _timed(lambda: LG._fit_common(matvec, rmat, N_ROWS, Xd.dtype, N_COLS, y_idx[k], wd, mu,
                                                          d_scale, total_w, **kw))
        n_iter, reads = state["n_iter_"], state["host_reads_"]
        if syncs["n"] != reads:
            fail(f"LogReg {name} loop: {syncs['n']} host waits for the card, the solver counted {reads} reads")
        public = models[name]
        if n_iter != public.n_iter_:
            fail(f"LogReg {name} loop on resident rows: n_iter_ {n_iter}, the public fit's {public.n_iter_}")
        k_out = kw["k"] if kw["multinomial"] else 1
        b = torch.randn((N_COLS, k_out), dtype=Xd.dtype, device=dev)
        r = torch.randn((N_ROWS, k_out), dtype=Xd.dtype, device=dev)
        itemsize = 2 if fast_ else 4
        loops[name] = {"n_iter": n_iter, "stalled": bool(state["stalled_"]), "loop_s": loop_s,
                       "ms_per_iter": loop_s * 1e3 / max(n_iter, 1), "host_reads": reads,
                       "reads_per_iter": reads / max(n_iter, 1), **_pair_ms(matvec, rmat, b, r, itemsize)}
        del matvec, rmat, state
        torch.cuda.empty_cache()
    timings["loops"] = loops

    # bf16 against float32: the objective at tests/test_precision.py's rtol
    # 1e-3; the coefficients (the flat standardized iterate) within
    # 4·2⁻⁹·κ(H), κ of the Hessian at the float32 solution (PERF.md §4)
    x32 = _flat_iterate(base, mu, d_scale, Xd.dtype)
    x16 = _flat_iterate(fast, mu, d_scale, Xd.dtype)
    (lo, hi), timings["hessian_s"] = _timed(lambda: _glm_eigs(Xd, wd, x32, mu, d_scale, total_w,
                                                              LOGREG_ROW["regParam"]))
    kappa = hi / lo
    c_rel = float(torch.linalg.vector_norm(x16 - x32) / torch.linalg.vector_norm(x32))
    f_rel = abs(fast.objective_ / base.objective_ - 1)
    if f_rel > 1e-3 or c_rel > 4 * BF16_U * kappa:
        fail(f"LogReg bf16 against float32: objective off by rtol {f_rel} (bound 1e-3) or coefficients by {c_rel} "
             f"relative (bound 4·2^-9·κ = {4 * BF16_U * kappa}, κ = {kappa})")
    del Xd, wd, y_idx, x32, x16
    torch.cuda.empty_cache()
    say(f"  loops on resident rows (placing X {timings['place_rows_s']:.3f} s, standardization pass "
        f"{timings['scaling_s']:.4f} s, bf16 staging {timings['bf16_staging_s']:.4f} s): "
        + "; ".join(f"{n} {v['n_iter']} iterations (stalled {v['stalled']}) {v['ms_per_iter']:.2f} ms each, "
                    f"{v['reads_per_iter']:.2f} host reads each (= the card's sync count), X·b + Xᵀ·r "
                    f"{v['pair_ms']:.3f} ms (bound {v['pair_bound_ms']:.2f}; X·b {v['matvec_ms']:.3f}, Xᵀ·r "
                    f"{v['rmat_ms']:.3f})" for n, v in loops.items())
        + f"; bf16 products through torch.mm(bf16, bf16, out_dtype=torch.float32); bf16 objective within rtol "
        f"{f_rel:.3g} of float32, coefficients {c_rel:.3g} relative (bound {4 * BF16_U * kappa:.3g}, Hessian "
        f"eigenvalues {lo:.4g}..{hi:.4g}, κ {kappa:.4g}, {timings['hessian_s']:.2f} s)")

    # serving: the binomial and the multinomial model in one registry,
    # coalesced = solo = transform, bit for bit
    registry = ModelRegistry()
    loads = (("logreg_bin", base, outs["baseline"]), ("logreg_multi", multi, outs["multinomial"]))
    for name, m, _ in loads:
        _, timings[f"load_{name}_s"] = _timed(lambda: registry.load(name, m))
    traffic = _serve_traffic(2031, LOGREG_SERVE_CLIENTS, LOGREG_SERVE_REQUESTS, TRANSFORM_ROWS)
    telemetry.registry().reset()
    telemetry.enable()
    engine = ScoringEngine(registry).start()
    futures = [[] for _ in traffic]

    def client(t):
        for lo_, n in traffic[t]:
            futures[t].append([engine.submit(name, X[lo_:lo_ + n]) for name, _, _ in loads])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(len(traffic))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = [[[f.result(timeout=600) for f in per_req] for per_req in fut] for fut in futures]
    timings["traffic_s"] = time.perf_counter() - t0
    stats = engine.stats()
    engine.stop()
    telemetry.disable()
    solo_engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
    try:
        for t, reqs in enumerate(traffic):
            for (lo_, n), got in zip(reqs, results[t]):
                for (name, _, whole), g in zip(loads, got):
                    ref = solo_engine.score(name, X[lo_:lo_ + n], timeout=600)
                    for part, alone, all_rows in zip(g, ref, whole):
                        if not (part.dtype == alone.dtype and np.array_equal(part, alone)):
                            fail(f"serving: {name} response to rows {lo_}..{lo_ + n} differs from the same request "
                                 "served alone")
                        if not np.array_equal(part.astype(np.float64), all_rows[lo_:lo_ + n]):
                            fail(f"serving: {name} response to rows {lo_}..{lo_ + n} differs from the transform")
    finally:
        solo_engine.stop()
    registry.clear()
    say(f"  serving loads logreg_bin {timings['load_logreg_bin_s']:.2f} s, logreg_multi "
        f"{timings['load_logreg_multi_s']:.2f} s; traffic {LOGREG_SERVE_CLIENTS} clients x {LOGREG_SERVE_REQUESTS} "
        f"requests to each: {timings['traffic_s']:.2f} s wall, {stats['batches']} batches, "
        f"{stats['coalesced_batches']} coalesced, e2e p50 {stats['e2e_p50_s'] * 1e3:.1f} ms, p99 "
        f"{stats['e2e_p99_s'] * 1e3:.1f} ms; every (raw, prob) equals the same request served alone and the "
        "transform, bit for bit")
    timings["serve_stats"] = stats
    torch.cuda.empty_cache()
    return {"baseline": base, "y": labels[2]}, timings


def phase_logreg_f64(dev, X64, ref):
    """Phase 8b: BASELINE.md's LogisticRegression row with
    float32_inputs=False on the float64 rows, and 8a's float32 fit held to
    it within the bounds of PERF.md section 4, computed here in float64 from
    the float64 fit: the objective within 3·ε_f + ‖g64‖²/(2μ), the flat
    standardized coefficients within √(2·max(F(β32) − F(β64) + ‖g64‖²/(2μ),
    0)/μ) + ‖g64‖/μ (μ the Hessian's smallest eigenvalue at β64)."""
    import torch

    from spark_rapids_ml_tpu_torch import LogisticRegression
    from spark_rapids_ml_tpu_torch.ops import linalg as L
    from spark_rapids_ml_tpu_torch.ops import logistic as LG
    from spark_rapids_ml_tpu_torch.ops.owlqn import run_lockstep
    from spark_rapids_ml_tpu_torch.parallel import host_tensor, place_rows

    say("phase 8b: LogisticRegression with float32_inputs=False, held to phase 8a's float32 fit")
    timings = {}
    base32 = ref["baseline"]
    y = ref["y"].astype(np.float64)
    m64, timings["fit_s"] = _timed(
        lambda: LogisticRegression(float32_inputs=False, **LOGREG_ROW).fit({"features": X64, "label": y}))
    if m64.dtype != "float64" or not np.isfinite(m64.coef_).all():
        fail("float64 LogReg fit: coefficients not finite float64")
    (Xd, wd), timings["place_rows_s"] = _timed(lambda: place_rows(X64, device=dev))
    y_idx = host_tensor(ref["y"].astype(np.int64)).to(dev)
    (mu, d_scale, total_w), timings["scaling_s"] = _timed(lambda: LG._make_scaling(Xd, wd, True, True))
    matvec, rmat = LG._dense_ops(Xd)
    kw = dict(k=2, multinomial=False, lam_l2=LOGREG_ROW["regParam"], fit_intercept=True)
    prob = LG._build_glm_problem(Xd.dtype, N_COLS, y_idx, wd, mu, d_scale, total_w, **kw)

    def served(solve):
        (out,), _ = run_lockstep([solve], matvec, rmat)
        return out

    with _counting_syncs() as syncs:
        state, loop_s = _timed(lambda: LG._fit_common(
            matvec, rmat, N_ROWS, Xd.dtype, N_COLS, y_idx, wd, mu, d_scale, total_w, lam_l1=0.0, use_l1=False,
            max_iter=LOGREG_ROW["maxIter"], tol=LOGREG_ROW["tol"], lbfgs_memory=10, **kw))
    if syncs["n"] != state["host_reads_"] or state["n_iter_"] != m64.n_iter_:
        fail(f"float64 LogReg loop: {syncs['n']} host waits, {state['host_reads_']} reads counted, n_iter_ "
             f"{state['n_iter_']} against the public fit's {m64.n_iter_}")
    b = torch.randn((N_COLS, 1), dtype=Xd.dtype, device=dev)
    r = torch.randn((N_ROWS, 1), dtype=Xd.dtype, device=dev)
    timings["loop"] = {"n_iter": state["n_iter_"], "stalled": bool(state["stalled_"]), "loop_s": loop_s,
                       "ms_per_iter": loop_s * 1e3 / max(state["n_iter_"], 1),
                       "reads_per_iter": state["host_reads_"] / max(state["n_iter_"], 1),
                       **_pair_ms(matvec, rmat, b, r, 8)}
    del state
    # the bounds' ingredients, in float64 at the float64 fit
    x64 = _flat_iterate(m64, mu, d_scale, Xd.dtype)
    x32 = _flat_iterate(base32, mu, d_scale, Xd.dtype)
    z64 = served(prob["z_solve"](x64))
    f64 = float(prob["rowloss"](z64) + prob["penalty_terms"](x64, torch.zeros_like(x64))[0])
    g64 = float(torch.linalg.vector_norm(served(prob["grad_solve"](x64, z64))))
    f_at32 = float(prob["rowloss"](served(prob["z_solve"](x32))) + prob["penalty_terms"](x32, torch.zeros_like(x32))[0])
    (lo, hi), timings["hessian_s"] = _timed(lambda: _glm_eigs(Xd, wd, x64, mu, d_scale, total_w,
                                                              LOGREG_ROW["regParam"]))
    # ε_f: float32's rounding of the objective at the fit, from the rows'
    # losses and the margins' absolute sums Σ_j |x_ij·Beff_j|
    beff = (x64[:N_COLS] * d_scale).abs()
    y64 = y_idx.to(Xd.dtype)
    s_sum = torch.zeros((), dtype=Xd.dtype, device=dev)
    for rows in L.row_tiles(N_ROWS):
        zt = z64[rows, 0]
        loss = LG.softplus(zt) - y64[rows] * zt
        s_sum += torch.sum(wd[rows] * (loss.abs() + (torch.sigmoid(zt) - y64[rows]).abs()
                                       * (Xd[rows].abs() @ beff + (x64[N_COLS:] - mu @ (x64[:N_COLS] * d_scale)).abs())))
    S = float(s_sum / total_w)
    eps_f = (int(np.ceil(np.log2(N_ROWS))) + int(np.ceil(np.log2(N_COLS))) + 4) * F32_U * S
    tail = g64 ** 2 / (2 * lo)
    f_err = abs(base32.objective_ - f64)
    # the reported value's own rounding (ε_f), and the float32 loop stopping
    # where its Armijo test, a difference of two such values, sees no more
    # decrease (2·ε_f); the float64 fit's distance from the optimum (tail)
    f_bound = 3 * eps_f + tail
    c_err = float(torch.linalg.vector_norm(x32 - x64))
    c_bound = float(np.sqrt(2 * max(f_at32 - f64 + tail, 0.0) / lo) + g64 / lo)
    del Xd, wd, y_idx, z64, matvec, rmat, prob
    torch.cuda.empty_cache()
    if f_err > f_bound or c_err > c_bound:
        fail(f"8b: float32 objective off by {f_err} (bound {f_bound}) or flat coefficients by {c_err} "
             f"(bound {c_bound})")
    lp = timings["loop"]
    say(f"  float64 fit {timings['fit_s']:.2f} s wall, n_iter_ {m64.n_iter_}, objective {m64.objective_:.12g}; "
        f"on resident rows (placing {timings['place_rows_s']:.3f} s, standardization {timings['scaling_s']:.4f} s): "
        f"{lp['n_iter']} iterations (stalled {lp['stalled']}) {lp['ms_per_iter']:.2f} ms each, "
        f"{lp['reads_per_iter']:.2f} host reads each, X·b + Xᵀ·r {lp['pair_ms']:.3f} ms (bound "
        f"{lp['pair_bound_ms']:.2f}; X·b {lp['matvec_ms']:.3f}, Xᵀ·r {lp['rmat_ms']:.3f}); float32 against float64: objective within {f_err:.3g} (bound {f_bound:.3g}: "
        f"ε_f {eps_f:.3g}, ‖g64‖ {g64:.3g}, μ {lo:.4g}), flat coefficients within {c_err:.3g} (bound "
        f"{c_bound:.3g}; F(β32) − F(β64) = {f_at32 - f64:.3g}; Hessian {lo:.4g}..{hi:.4g}, "
        f"{timings['hessian_s']:.2f} s)")
    return timings


# ------------------------------------------------------------ phase 9 ----

# BASELINE.md's two RandomForest rows, nothing cut; the numTrees of the
# refit that must repeat the first trees; the rows held against the CPU's
# descent and the rows of the training-quality gates; 9a's small input
# (rows, columns; trees, depth, bins); the serving traffic
# BASELINE.md's rows, their tree counts halved (50 and 30) for the script's
# time: every level, split and descent path of a tree is there in the first
RF_CONFIGS = (
    ("classifier", {"numTrees": 25, "maxDepth": 13, "maxBins": 128}),
    ("regressor", {"numTrees": 15, "maxDepth": 6, "maxBins": 128}),
)
RF_REFIT_TREES = 2
RF_DESCENT_ROWS, RF_QUALITY_ROWS = 4096, 100_000
# the transforms of phases 7a, 8a and 9 run over the first TRANSFORM_ROWS rows
# (cut from all 1M for the script's time; every gate reads rows
# within them)
TRANSFORM_ROWS = 200_000
RF_SMALL, RF_SMALL_FOREST = (20000, 40), {"numTrees": 4, "maxDepth": 6, "maxBins": 32, "seed": 11}
RF_SERVE_CLIENTS, RF_SERVE_REQUESTS = 2, 4
# 9a's entropy gate: a node may split elsewhere on the card only where its
# two best gains lie within this relative distance (log2 differs in its last
# bits between the CPU and the card)
RF_TIE_RTOL = 1e-6


@contextlib.contextmanager
def _forest_timers(levels=False, edges=None):
    """Times the forest fit's parts while the body runs, each call waited
    for on the card: the quantile sketch, the binning and forest_fit, and
    with `levels` every level and its histogram pass by depth (ms lists).
    The sketch's edges land in box["edges"]; given `edges`, the sketch
    returns them instead of computing them again (a refit of the same
    rows)."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import trees as TR

    box = {"sketch_s": 0.0, "bin_s": 0.0, "forest_s": 0.0, "level_ms": {}, "hist_ms": {}}
    names = ("quantile_bins", "bin_features", "forest_fit", "_tree_level", "_histogram")
    real = {k: getattr(TR, k) for k in names}
    depth = {"now": 0}

    def timed(fn, add):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            add(time.perf_counter() - t0, a)
            return out
        return run

    def put(key):
        def add(s, a):
            box[key] += s
        return add

    def level(s, a):
        box["level_ms"].setdefault(a[-1], []).append(s * 1e3)

    def hist(s, a):
        lst = box["hist_ms"].setdefault(depth["now"], [])
        lst.append(s * 1e3)

    def level_fn(*a, **kw):
        depth["now"] = a[-1]
        return timed(real["_tree_level"], level)(*a, **kw)

    def sketch(*a, **kw):
        box["edges"] = real["quantile_bins"](*a, **kw) if edges is None else edges
        return box["edges"]

    TR.quantile_bins = timed(sketch, put("sketch_s"))
    TR.bin_features = timed(real["bin_features"], put("bin_s"))
    TR.forest_fit = timed(real["forest_fit"], put("forest_s"))
    if levels:
        TR._tree_level = level_fn
        TR._histogram = timed(real["_histogram"], hist)
    try:
        yield box
    finally:
        for k, fn in real.items():
            setattr(TR, k, fn)


def _forest_arrays(m):
    return m.feature, m.threshold, m.node_stats


def _same_forest(a, b, trees=None):
    """Whether two forests' (or their first `trees` trees') arrays are equal
    bit for bit."""
    t = slice(None) if trees is None else slice(0, trees)
    return all(x[t].dtype == y.dtype and np.array_equal(x[t], y, equal_nan=True)
               for x, y in zip(_forest_arrays(a), (v[t] for v in _forest_arrays(b))))


def _cpu_descent(m, x):
    """The plain CPU descent of a fitted forest over host rows x: the mean
    of the trees' leaf values at the model's dtype (what its transform
    computes on the card)."""
    import torch

    from spark_rapids_ml_tpu_torch.ops.trees import forest_raw_predict

    dtype = np.float32 if m._float32_inputs else np.float64
    return forest_raw_predict(torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)),
                              torch.from_numpy(m.feature.astype(np.int64)),
                              torch.from_numpy(m.threshold.astype(dtype)),
                              torch.from_numpy(m._leaf_values().astype(dtype)), max_depth=m.max_depth).numpy()


def _first_splits_apart(a, b):
    """(tree, node) of the nodes where two forests first part: a node whose
    split or statistics differ while its parent's agree."""
    same = ((a.feature == b.feature) & (a.threshold == b.threshold)
            & (a.node_stats == b.node_stats).all(axis=-1))
    out = []
    for t, i in np.argwhere(~same):
        if i == 0 or same[t, (i - 1) // 2]:
            out.append((int(t), int(i)))
    return out


def _small_forest_reference():
    """9a: the forests through the public API on a small input, on the card
    and on the CPU, bootstrap on, featureSubsetStrategy "auto", float32 and
    float64: a 3-class classifier under gini and entropy and a regressor on
    integer labels. Gini and variance forests equal bit for bit; an entropy
    forest may part only at a node whose two best gains lie within
    RF_TIE_RTOL (printed); each fit twice on the card, bit for bit; the
    binning of values equal to an edge, of ±inf and NaN equal; fault C3's
    row gives probability [0, 1] on the card."""
    import torch

    from spark_rapids_ml_tpu_torch import (LogisticRegression, RandomForestClassifier, RandomForestRegressor,
                                           set_devices)
    from spark_rapids_ml_tpu_torch.ops import trees as TR

    rng = np.random.default_rng(17)
    n, d = RF_SMALL
    x = rng.standard_normal((n, d)).astype(np.float32)
    y3 = np.argmax(x[:, :3] + 0.7 * rng.standard_normal((n, 3)), axis=1).astype(np.float32)
    yi = np.round(2 * x[:, 0] + x[:, 1] ** 2 + rng.standard_normal(n)).astype(np.float32)
    fits = {"gini": (RandomForestClassifier, {"impurity": "gini"}, y3),
            "entropy": (RandomForestClassifier, {"impurity": "entropy"}, y3),
            "variance": (RandomForestRegressor, {}, yi)}
    real_gains = TR._gains_from_sides
    ties = []
    for f32 in (True, False):
        xs = x if f32 else x.astype(np.float64)
        models, gains = {}, {}
        for device in ("cpu", "cuda", "cuda"):
            set_devices(device)
            for name, (cls, params, labels) in fits.items():
                seen = []

                def record(*a, **kw):
                    g = real_gains(*a, **kw)
                    seen.append(g.reshape(g.shape[0], -1).cpu().numpy())
                    return g

                TR._gains_from_sides = record
                try:
                    m = cls(float32_inputs=f32, **RF_SMALL_FOREST, **params).fit({"features": xs, "label": labels})
                finally:
                    TR._gains_from_sides = real_gains
                if device in models.get(name, {}):
                    if not _same_forest(models[name][device], m):
                        fail(f"9a: {name} forest (float32_inputs={f32}) fitted twice on the card differs")
                    continue
                models.setdefault(name, {})[device] = m
                gains.setdefault(name, {})[device] = seen
        set_devices(None)
        for name in fits:
            mc, mg = models[name]["cpu"], models[name]["cuda"]
            if name != "entropy":
                if not _same_forest(mc, mg):
                    fail(f"9a: {name} forest (float32_inputs={f32}) differs between the card and the CPU")
                continue
            depth = RF_SMALL_FOREST["maxDepth"]
            for t, i in _first_splits_apart(mc, mg):
                level = int(np.log2(i + 1))
                g = np.sort(gains[name]["cpu"][t * depth + level][i - (2 ** level - 1)])[::-1]
                if not (np.isfinite(g[1]) and g[0] - g[1] <= RF_TIE_RTOL * abs(g[0])):
                    fail(f"9a: entropy forest (float32_inputs={f32}) tree {t} node {i} splits apart on the card "
                         f"and the CPU, its two best gains {g[0]!r} and {g[1]!r} not within {RF_TIE_RTOL}")
                ties.append((f32, t, i, float(g[0]), float(g[1])))
    # binning: values equal to each edge, one float32 step either side, ±inf, NaN
    edges = TR.quantile_bins(x, 32).astype(np.float32)
    probe = np.concatenate([edges.T, np.nextafter(edges.T, np.float32(np.inf)),
                            np.nextafter(edges.T, np.float32(-np.inf)),
                            np.full((3, d), [[np.inf], [-np.inf], [np.nan]], np.float32)])
    bins = [TR.bin_features(torch.from_numpy(probe).to(dev), torch.from_numpy(edges)).cpu().numpy()
            for dev in ("cpu", "cuda")]
    if not np.array_equal(bins[0], bins[1]):
        fail("9a: binning on the card differs from the CPU's on edges, ±inf or NaN")
    # C3: a binomial margin of +inf gives probability [0, 1] on the card
    rng1 = np.random.default_rng(1)
    xc = rng1.normal(size=(300, 6))
    yc = (xc @ rng1.normal(size=6) + 0.5 * rng1.normal(size=300) > 0).astype(np.float64)
    lr = LogisticRegression(regParam=0.01).fit({"features": xc.astype(np.float32), "label": yc})
    q = (3e38 * np.sign(lr.coef_[0])).astype(np.float32)[None, :]
    out = lr.transform({"features": q})
    if not (np.array_equal(out["probability"][0], [0.0, 1.0]) and out["prediction"][0] == 1.0):
        fail(f"9a: C3's row gives probability {out['probability'][0]} and prediction {out['prediction'][0]} on "
             "the card, not [0, 1] and 1.0")
    say(f"  9a, {n} x {d}, {RF_SMALL_FOREST}, bootstrap on, featureSubsetStrategy auto, float32 and float64: gini "
        f"and variance forests equal on the card and the CPU bit for bit, each fit twice on the card bit for bit; "
        f"entropy nodes parted at near-ties: {ties or 'none'}; binning of {len(probe)} x {d} edge, ±inf and NaN "
        "values equal; C3's row gives probability [0, 1], prediction 1.0 on the card")


def phase_forests(dev, X):
    """Phase 9: BASELINE.md's RandomForestClassifier {numTrees=50 cut to 25,
    maxDepth=13, maxBins=128} and RandomForestRegressor {numTrees=30 cut to
    15, maxDepth=6, maxBins=128} through the public API on the protocol rows
    (float32): 9a on a small input against the CPU, then for each forest
    fit (its parts timed), transform of the first TRANSFORM_ROWS rows, save/load bit for bit, a
    refit of RF_REFIT_TREES trees repeating the first trees bit for bit
    (levels timed), the first rows against the CPU's descent bit for bit and
    the training-quality gates; 9d, one ModelRegistry serving both,
    coalesced = solo = transform bit for bit. No kernel is launched."""
    import threading

    import torch

    from spark_rapids_ml_tpu_torch import (ModelRegistry, RandomForestClassificationModel, RandomForestClassifier,
                                           RandomForestRegressionModel, RandomForestRegressor, ScoringEngine,
                                           telemetry)
    from spark_rapids_ml_tpu_torch.ops import _kernels

    say(f"phase 9: RandomForestClassifier and RandomForestRegressor, {N_ROWS} x {N_COLS} float32")
    timings = {}
    before = dict(_kernels.launches)
    _, timings["small_s"] = _timed(_small_forest_reference)
    labels = {"classifier": _class_labels(X, 2), "regressor": _labels(X)[0]}
    classes = {"classifier": (RandomForestClassifier, RandomForestClassificationModel),
               "regressor": (RandomForestRegressor, RandomForestRegressionModel)}
    models, outs = {}, {}
    head = X[:RF_DESCENT_ROWS]
    for name, params in RF_CONFIGS:
        est_cls, model_cls = classes[name]
        data = {"features": X, "label": labels[name]}
        with _forest_timers() as tm:
            m, fit_s = _timed(lambda: est_cls(**params).fit(data))
        T, depth = params["numTrees"], params["maxDepth"]
        M = 2 ** (depth + 1) - 1
        if m.feature.shape != (T, M) or not np.isfinite(m.node_stats).all() or not (m.feature[:, 0] >= 0).all():
            fail(f"RF {name}: feature {m.feature.shape} (want ({T}, {M})), non-finite statistics or an unsplit root")
        out, transform_s = _timed(lambda: m.transform({"features": X[:TRANSFORM_ROWS]}))
        mean = _cpu_descent(m, head).astype(np.float64)
        q = slice(0, RF_QUALITY_ROWS)
        if name == "classifier":
            raw = np.stack(out["rawPrediction"].to_numpy())
            prob = np.stack(out["probability"].to_numpy())
            pred = np.asarray(out["prediction"])
            if raw.shape != (TRANSFORM_ROWS, 2) or not np.isfinite(prob).all():
                fail(f"RF {name} transform: not finite of shape ({TRANSFORM_ROWS}, 2)")
            if not np.array_equal(raw[:RF_DESCENT_ROWS], mean * T):
                fail(f"RF {name}: the first {RF_DESCENT_ROWS} rows of the transform differ from the CPU's descent")
            row_sums = float(np.abs(prob.sum(axis=1) - 1.0).max())
            if row_sums > 1e-6:
                fail(f"RF {name}: a row of probabilities sums to 1 ± {row_sums}")
            if not np.array_equal(pred, m.classes_[np.argmax(prob, axis=1)]):
                fail(f"RF {name}: the prediction column is not the argmax of the probabilities")
            acc = float(np.mean(pred[q] == labels[name][q]))
            majority = float(np.bincount(labels[name][q].astype(np.int64)).max() / len(labels[name][q]))
            if not acc > majority:
                fail(f"RF {name}: training accuracy {acc} on the first {RF_QUALITY_ROWS} rows, not above the "
                     f"majority-class rate {majority}")
            quality = f"training accuracy {acc:.4f} (majority {majority:.4f}), rows sum to 1 within {row_sums:.3g}"
        else:
            pred = np.asarray(out["prediction"])
            if pred.shape != (TRANSFORM_ROWS,) or not np.isfinite(pred).all():
                fail(f"RF {name} transform: not finite of shape ({TRANSFORM_ROWS},)")
            if not np.array_equal(pred[:RF_DESCENT_ROWS].astype(np.float64), mean[:, 0]):
                fail(f"RF {name}: the first {RF_DESCENT_ROWS} rows of the transform differ from the CPU's descent")
            yq = labels[name][q].astype(np.float64)
            r2 = 1.0 - float(np.sum((pred[q] - yq) ** 2) / np.sum((yq - yq.mean()) ** 2))
            if not r2 > 0:
                fail(f"RF {name}: training R² {r2} on the first {RF_QUALITY_ROWS} rows, not above 0")
            quality = f"training R² {r2:.4f}"
        path = ROOT / "build" / f"chip_smoke_rf_{name}"
        m.write().overwrite().save(str(path))
        loaded = model_cls.load(str(path))
        if not (_same_forest(loaded, m) and np.array_equal(loaded._transform_arrays(head), m._transform_arrays(head))):
            fail(f"RF {name} save/load: the loaded model differs from the fitted one")
        # the refit bins with the first fit's edges: the same rows, seed and
        # maxBins give the same sketch, which is not run again (PR 21's cut)
        with _forest_timers(levels=True, edges=tm["edges"]) as lv:
            refit = est_cls(**dict(params, numTrees=RF_REFIT_TREES)).fit(data)
        if not _same_forest(m, refit, trees=RF_REFIT_TREES):
            fail(f"RF {name}: a refit of {RF_REFIT_TREES} trees differs from trees 0-{RF_REFIT_TREES - 1} of the first")
        t = {"fit_s": fit_s, "transform_s": transform_s, "sketch_s": tm["sketch_s"], "bin_s": tm["bin_s"],
             "forest_s": tm["forest_s"], "s_per_tree": tm["forest_s"] / T,
             "bin_GB_s": N_ROWS * N_COLS / tm["bin_s"] / 1e9,
             "level_ms": {k: float(np.mean(v)) for k, v in sorted(lv["level_ms"].items())},
             "hist_ms": {k: float(np.mean(v)) for k, v in sorted(lv["hist_ms"].items())},
             "nodes_split": int((m.feature >= 0).sum()), "total_nodes": m.totalNumNodes}
        timings[name] = t
        models[name], outs[name] = m, (raw if name == "classifier" else pred)
        say(f"  {name} {params}: fit {fit_s:.2f} s wall = quantile sketch {t['sketch_s']:.2f} s + binning "
            f"{t['bin_s']:.3f} s ({N_ROWS * N_COLS / 1e9:.0f} GB of bin ids written, {t['bin_GB_s']:.1f} GB/s) + "
            f"forest {t['forest_s']:.2f} s ({t['s_per_tree']:.3f} s per tree) + the rest (placing X, labels); "
            f"{t['nodes_split']} split nodes; level ms at depth 0 / {depth - 1}: {t['level_ms'][0]:.2f} / "
            f"{t['level_ms'][depth - 1]:.2f} (histogram pass {t['hist_ms'][0]:.2f} / {t['hist_ms'][depth - 1]:.2f}); "
            f"transform {transform_s:.2f} s wall; {quality}; the first {RF_DESCENT_ROWS} rows equal the CPU's "
            f"descent, save/load and the {RF_REFIT_TREES}-tree refit bit for bit")
        del out
    after = dict(_kernels.launches)
    if after != before:
        fail(f"RF: kernel launch counters moved in phase 9: {before} -> {after}")

    # 9d: both forests in one registry, coalesced = solo = transform
    registry = ModelRegistry()
    for name in models:
        _, timings[f"load_{name}_s"] = _timed(lambda: registry.load(f"rf_{name}", models[name]))
    traffic = _serve_traffic(2033, RF_SERVE_CLIENTS, RF_SERVE_REQUESTS, TRANSFORM_ROWS)
    telemetry.registry().reset()
    telemetry.enable()
    engine = ScoringEngine(registry).start()
    futures = [[] for _ in traffic]

    def client(t_):
        for lo_, n in traffic[t_]:
            futures[t_].append([engine.submit(f"rf_{name}", X[lo_:lo_ + n]) for name in models])

    threads = [threading.Thread(target=client, args=(t_,)) for t_ in range(len(traffic))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    results = [[[f.result(timeout=600) for f in per_req] for per_req in fut] for fut in futures]
    timings["traffic_s"] = time.perf_counter() - t0
    stats = engine.stats()
    engine.stop()
    telemetry.disable()
    solo_engine = ScoringEngine(registry, coalesce_window_s=0.0).start()
    try:
        for t_, reqs in enumerate(traffic):
            for (lo_, n), got in zip(reqs, results[t_]):
                for name, g in zip(models, got):
                    alone = solo_engine.score(f"rf_{name}", X[lo_:lo_ + n], timeout=600)
                    if not (g.dtype == alone.dtype and np.array_equal(g, alone)):
                        fail(f"serving: rf_{name} response to rows {lo_}..{lo_ + n} differs from the same request "
                             "served alone")
                    whole = outs[name][lo_:lo_ + n]
                    as_col = (g.astype(np.float64) * models[name].num_trees if name == "classifier"
                              else g[:, 0])
                    if not np.array_equal(as_col, whole):
                        fail(f"serving: rf_{name} response to rows {lo_}..{lo_ + n} differs from the transform")
    finally:
        solo_engine.stop()
    registry.clear()
    timings["serve_stats"] = stats
    say(f"  serving loads rf_classifier {timings['load_classifier_s']:.2f} s, rf_regressor "
        f"{timings['load_regressor_s']:.2f} s; traffic {RF_SERVE_CLIENTS} clients x {RF_SERVE_REQUESTS} requests to "
        f"each: {timings['traffic_s']:.2f} s wall, {stats['batches']} batches, {stats['coalesced_batches']} "
        f"coalesced, e2e p50 {stats['e2e_p50_s'] * 1e3:.1f} ms, p99 {stats['e2e_p99_s'] * 1e3:.1f} ms; every "
        "response equals the same request served alone and the transform, bit for bit; kernel launches: none")
    torch.cuda.empty_cache()
    return timings


# ------------------------------------------------------------------ main --


# ------------------------------------------------------------ phase 10 ----

# 10a: benchmark/bench_cv.py's run_cv_fit at BASELINE.md's width; 10b: the
# CD row's tol and maxIter over a 2 x 2 grid; 10c: an OWL-QN group of two;
# 10d: KMeans fitMultiple over two k; 10e: 9a's small input
CV_LOGREG = {"maxIter": 30, "tol": 1e-12}
CV_REGS = tuple(float(v) for v in np.logspace(-6, -3, 4))
CV_FOLDS, CV_SEED = 3, 0
CV_LINEAR = {"tol": 1e-30, "maxIter": 2}  # the CD row's 10 sweeps cut to 2 for the script's time
CV_LINEAR_REGS, CV_LINEAR_ENETS = (1e-5, 1e-3), (0.0, 0.5)
TVS_OWLQN = {"regParam": 1e-2, "maxIter": 30}
TVS_ENETS, TVS_RATIO, TVS_SEED = (0.5, 1.0), 0.75, 0
KMEANS_MULTI_K, KMEANS_MULTI = (500, 1000), {"maxIter": 3, "tol": 1e-20, "initMode": "random", "seed": 1}
SMALL_CV_GRID = {"maxDepth": (4, 6)}


@contextlib.contextmanager
def _fit_internal_timer(cls):
    """Times each `_fit_internal` call of `cls` (a fold's masked grid fit,
    or a single fit), waited for on the card: a list of (masked, s)."""
    import torch

    real = cls._fit_internal
    box = []

    def timed(self, dataset, maps, row_mask=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, dataset, maps, row_mask)
        torch.cuda.synchronize()
        box.append((row_mask is not None, time.perf_counter() - t0))
        return out

    cls._fit_internal = timed
    try:
        yield box
    finally:
        cls._fit_internal = real


def _engine_counters():
    from spark_rapids_ml_tpu_torch import telemetry

    snap = telemetry.registry().snapshot()
    c = snap["counters"]
    layout = snap["histograms"].get("device_wait.layout_s", {})
    return {k: int(c.get(k, 0)) for k in ("ingest.datasets", "fit.device_dataset_builds", "fit.device_dataset_reuses",
                                          "fit.solves_batched", "fit.solves_sequential")}, layout


def _check_counters(tag, got, want):
    for key, n in want.items():
        if got[key] != n:
            fail(f"{tag}: counter {key} is {got[key]}, expected {n} ({got})")


def _masked_models(est, data, grid, mask):
    """The single fits of `grid` on the rows of `mask`, the mask written as
    a weight column, over one placement: (models, the placed rows, which
    the caller scores held-out rows from as the engine does)."""
    from spark_rapids_ml_tpu_torch import core

    data_w = dict(data, w_fold=mask.astype(np.float32))
    est_w = est.copy()._set_params(weightCol="w_fold")
    with core.device_dataset_scope() as scope:
        models = [est_w.copy(pm).fit(data_w) for pm in grid]
        X = scope.last.inputs.X
    return models, X


def phase_multifit(dev, X, y_lin, y_cls):
    """Phase 10: the multi-fit engine at full width, on the float32 protocol
    rows after phase 9, through the public API (CrossValidator,
    TrainValidationSplit, fitMultiple), then on 9a's small input against
    the CPU. Gates, fixed before the first run on the card:

    - 10a, CrossValidator(LogisticRegression(maxIter=30, tol=1e-12), grid
      regParam = logspace(-6, -3, 4), numFolds=3, seed=0, accuracy) on
      phase 8's binomial labels: the counters read exactly 1 ingest, 1
      placement (fit.device_dataset_builds), 3 reuses, 12 batched solves
      and 1 sequential refit. Fold 0's four batched models against the
      four single fits with the fold mask as a weight column: the same
      n_iter_, and coefficients, intercepts and fold accuracy EQUAL (bound
      0): the grid's products run in fixed column blocks, so a column's
      product is the single fit's bit for bit, and every other operation
      of a solve is the single fit's own. On resident rows, the batched
      grid reads the card once per iteration for the whole grid: its reads
      equal the longest single fit's, reads per iteration equal the single
      fit's, and the card's sync count equals the reads.
    - 10b, CrossValidator(LinearRegression(tol=1e-30, maxIter=2), grid
      regParam {1e-5, 1e-3} x elasticNetParam {0, 0.5}, numFolds=3, rmse)
      on phase 7's y: two batched groups per fold (normal equations, CD:
      6 calls of linear_fit_batched, 3 of each), 12 batched solves, 1
      sequential refit; on fold 0's statistics the batched CD equals the
      sequential CD of each point, n_iter_ maxIter and coefficients bit for bit
      (bound 0: each coordinate update is the same elementwise operations).
    - 10c, TrainValidationSplit(LogisticRegression(regParam=1e-2,
      maxIter=30), elasticNetParam {0.5, 1.0}, trainRatio 0.75): one
      batched OWL-QN group (2 batched solves, 1 refit); its models have
      their exact zeros where the single fits on the train rows have them,
      and the same n_iter_.
    - 10d, KMeans(maxIter=3, random init, seed 1).fitMultiple over k in
      {500, 1000}: one placement (1 ingest); each model's centers and
      transform equal to its single fit bit for bit (the kernels are
      deterministic, phase 2), centers finite and inertia finite; B1 and B2
      launched in the run named fit_multiple.
    - 10e, on 20000 x 40: CrossValidator over RandomForestClassifier
      (9a's forest, maxDepth {4, 6}, 2 folds) through the per-model
      fallback gives the same avgMetrics and the same best forest bit for
      bit on the card and the CPU; a Pipeline(PCA(k=3), LogisticRegression)
      fit, transform, save and load, the loaded pipeline's output equal to
      the fitted one's bit for bit.

    Returns (the fit_multiple launch counts, timings)."""
    import torch

    from spark_rapids_ml_tpu_torch import (KMeans, LinearRegression, LogisticRegression, MulticlassClassificationEvaluator,
                                           ParamGridBuilder, CrossValidator, RegressionEvaluator, TrainValidationSplit,
                                           telemetry)
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import linear as LR
    from spark_rapids_ml_tpu_torch.ops import logistic as LG
    from spark_rapids_ml_tpu_torch.parallel import host_tensor, place_rows

    say(f"phase 10: the multi-fit engine, {N_ROWS} x {N_COLS} float32")
    timings = {}
    telemetry.registry().reset()
    telemetry.enable()

    # 10a: CrossValidator over LogisticRegression --------------------------
    data = {"features": X, "label": y_cls}
    est = LogisticRegression(**CV_LOGREG)
    grid = ParamGridBuilder().addGrid(est.getParam("regParam"), list(CV_REGS)).build()
    acc = MulticlassClassificationEvaluator(metricName="accuracy")
    cv = CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=acc, numFolds=CV_FOLDS, seed=CV_SEED,
                        collectSubModels=True)
    with _fit_internal_timer(LogisticRegression) as fits:
        cvm, timings["cv_logreg_s"] = _timed(lambda: cv.fit(data))
    counts, layout = _engine_counters()
    _check_counters("10a", counts, {"ingest.datasets": 1, "fit.device_dataset_builds": 1,
                                    "fit.device_dataset_reuses": CV_FOLDS, "fit.solves_batched": CV_FOLDS * len(grid),
                                    "fit.solves_sequential": 1})
    timings["cv_logreg_placement_s"] = layout.get("sum")
    fold_s = [s for masked, s in fits if masked]
    timings["cv_logreg_fold_fit_s"] = fold_s
    timings["cv_logreg_refit_s"] = [s for masked, s in fits if not masked][0]
    if not np.isfinite(cvm.avgMetrics).all():
        fail(f"10a: avgMetrics {cvm.avgMetrics} not finite")
    folds = cv._kfold_indices(N_ROWS, data)
    train0, valid0 = folds[0]
    mask0 = np.zeros(N_ROWS, np.float32)
    mask0[train0] = 1.0
    seq, Xd = _masked_models(est, data, grid, mask0)
    batched = cvm.subModels[0]
    for j, (b, s) in enumerate(zip(batched, seq)):
        if b.n_iter_ != s.n_iter_:
            fail(f"10a: fold 0, map {j}: batched n_iter_ {b.n_iter_}, single fit {s.n_iter_}")
        if not (np.array_equal(b.coef_, s.coef_) and np.array_equal(b.intercept_, s.intercept_)):
            fail(f"10a: fold 0, map {j}: batched coefficients differ from the single fit's (max "
                 f"{np.abs(b.coef_ - s.coef_).max()}); the bound is 0")
    held = Xd.index_select(0, torch.from_numpy(valid0).to(dev))
    acc_b = batched[0]._combine(batched)._transform_evaluate_arrays(held, y_cls[valid0].astype(np.float64), acc)
    acc_s = seq[0]._combine(seq)._transform_evaluate_arrays(held, y_cls[valid0].astype(np.float64), acc)
    if acc_b != acc_s:
        fail(f"10a: fold 0 accuracies {acc_b} (batched) and {acc_s} (single fits) differ")
    del held, seq, Xd
    torch.cuda.empty_cache()

    # the grid on resident rows: ms per batched iteration against the single
    # fits', host reads against the card's syncs
    (Xr, _), timings["place_rows_s"] = _timed(lambda: place_rows(X, device=dev))
    w0 = host_tensor(mask0).to(dev)
    y_idx = host_tensor(y_cls.astype(np.int64)).to(dev)
    l2s = [float(r) for r in CV_REGS]
    kw = dict(k=2, multinomial=False, max_iter=CV_LOGREG["maxIter"], tol=CV_LOGREG["tol"])
    with _counting_syncs() as syncs:
        states, grid_s = _timed(lambda: LG.logistic_fit_batched(Xr, y_idx, w0, l2s, [0.0] * len(l2s), **kw))
    singles = []
    for l2, st in zip(l2s, states):
        with _counting_syncs() as syncs1:
            one, one_s = _timed(lambda: LG.logistic_fit(Xr, y_idx, w0, lam_l2=l2, **kw))
        if not (one["n_iter_"] == st["n_iter_"] and torch.equal(one["coef_"], st["coef_"])
                and torch.equal(one["intercept_"], st["intercept_"])):
            fail(f"10a on resident rows: regParam {l2}: the grid's state differs from logistic_fit's")
        if syncs1["n"] != one["host_reads_"]:
            fail(f"10a: a single fit waited for the card {syncs1['n']} times, it counted {one['host_reads_']} reads")
        singles.append((one["n_iter_"], one["host_reads_"], one_s))
    grid_reads = states[0]["grid_host_reads_"]
    if syncs["n"] != grid_reads:
        fail(f"10a: the grid waited for the card {syncs['n']} times, it counted {grid_reads} reads")
    iters, most_reads = max(n for n, _, _ in singles), max(r for _, r, _ in singles)
    if grid_reads != most_reads:
        fail(f"10a: the grid read the card {grid_reads} times in {iters} iterations, the longest single fit "
             f"{most_reads} times")
    seq_ms = float(np.mean([s * 1e3 / max(n, 1) for n, _, s in singles]))
    timings["glm_grid_ms_per_iter"] = grid_s * 1e3 / iters
    timings["glm_single_ms_per_iter"] = seq_ms
    timings["glm_grid_host_reads"] = grid_reads
    timings["glm_grid_n_iter"] = [st["n_iter_"] for st in states]
    # the products in column blocks (one column, the grid's S) against the
    # GEMV pair of a single fit before the blocks
    matvec, rmat = LG._dense_ops(Xr)
    b1, r1 = torch.randn((N_COLS, 1), device=dev), torch.randn((N_ROWS, 1), device=dev)
    bS, rS = torch.randn((N_COLS, len(l2s)), device=dev), torch.randn((N_ROWS, len(l2s)), device=dev)
    timings["pair_block_1"] = _pair_ms(matvec, rmat, b1, r1, 4)
    timings["pair_block_S"] = _pair_ms(matvec, rmat, bS, rS, 4)
    timings["pair_gemv"] = _pair_ms(lambda B: Xr @ B, lambda R: Xr.T @ R, b1, r1, 4)
    del Xr, w0, states, matvec, rmat, b1, r1, bS, rS
    torch.cuda.empty_cache()
    say(f"  10a CrossValidator(LogisticRegression({CV_LOGREG}), regParam {['%.0e' % r for r in CV_REGS]}, "
        f"{CV_FOLDS} folds, accuracy): {timings['cv_logreg_s']:.2f} s wall, placement "
        f"{timings['cv_logreg_placement_s']:.2f} s, fold fits {', '.join(f'{s:.2f}' for s in fold_s)} s, refit "
        f"{timings['cv_logreg_refit_s']:.2f} s, {13 / timings['cv_logreg_s']:.3g} solves/s; avgMetrics "
        f"{[round(float(v), 6) for v in cvm.avgMetrics]}; counters {counts}; fold 0's batched models equal the single "
        f"fits with the mask as a weight column (n_iter_ {[m.n_iter_ for m in batched]}, coefficients and "
        f"accuracies {acc_b} bit for bit); on resident rows one batched GLM iteration "
        f"{timings['glm_grid_ms_per_iter']:.2f} ms against {len(l2s)} x {seq_ms:.2f} = {len(l2s) * seq_ms:.2f} ms "
        f"sequential, {grid_reads} host reads for the grid in {iters} iterations (= the card's syncs, = the "
        f"longest single fit's); X·B + Xᵀ·R in column blocks of {LG.COL_BLOCK}: "
        + ", ".join(f"{name} {timings[key]['pair_ms']:.3f} ms (X·B {timings[key]['matvec_ms']:.3f}, Xᵀ·R "
                    f"{timings[key]['rmat_ms']:.3f})" for name, key in (("1 column", "pair_block_1"),
                                                                       (f"{len(l2s)} columns", "pair_block_S")))
        + f", against the GEMV pair {timings['pair_gemv']['pair_ms']:.3f} ms (X·b {timings['pair_gemv']['matvec_ms']:.3f}, "
        f"Xᵀ·r {timings['pair_gemv']['rmat_ms']:.3f}; bound {timings['pair_gemv']['pair_bound_ms']:.2f})")

    # 10b: CrossValidator over LinearRegression ---------------------------
    telemetry.registry().reset()
    data_lin = {"features": X, "label": y_lin}
    lin = LinearRegression(**CV_LINEAR)
    lgrid = (ParamGridBuilder().addGrid(lin.getParam("regParam"), list(CV_LINEAR_REGS))
             .addGrid(lin.getParam("elasticNetParam"), list(CV_LINEAR_ENETS)).build())
    calls = []
    real_batched = LR.linear_fit_batched

    def counted(*a, **kw_):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_batched(*a, **kw_)
        torch.cuda.synchronize()
        calls.append((bool(kw_["use_cd"]), time.perf_counter() - t0))
        return out

    LR.linear_fit_batched = counted
    try:
        lcv = CrossValidator(estimator=lin, estimatorParamMaps=lgrid, evaluator=RegressionEvaluator(metricName="rmse"),
                             numFolds=CV_FOLDS, seed=CV_SEED)
        lcvm, timings["cv_linear_s"] = _timed(lambda: lcv.fit(data_lin))
    finally:
        LR.linear_fit_batched = real_batched
    counts, layout = _engine_counters()
    _check_counters("10b", counts, {"ingest.datasets": 1, "fit.device_dataset_builds": 1,
                                    "fit.device_dataset_reuses": CV_FOLDS,
                                    "fit.solves_batched": CV_FOLDS * len(lgrid), "fit.solves_sequential": 1})
    if sorted(cd for cd, _ in calls) != [False] * CV_FOLDS + [True] * CV_FOLDS:
        fail(f"10b: the grid did not split into a normal-equation and a CD group per fold: {calls}")
    timings["cv_linear_placement_s"] = layout.get("sum")
    timings["cv_linear_group_s"] = calls
    # fold 0's statistics: the batched CD against each point's sequential CD
    (Xr, _), _ = _timed(lambda: place_rows(X, device=dev))
    w0 = host_tensor(mask0).to(dev)
    yl = host_tensor(y_lin.astype(np.float32)).to(dev)
    stats, timings["linear_stats_s"] = _timed(lambda: LR._sufficient_stats(Xr, yl, w0))
    cd = dict(fit_intercept=True, standardize=True, use_cd=True, max_iter=CV_LINEAR["maxIter"], tol=CV_LINEAR["tol"])
    enet = [e for e in CV_LINEAR_ENETS if e > 0][0]
    grid_cd, grid_cd_s = _timed(lambda: LR._solve_grid_from_stats(stats, Xr.dtype, list(CV_LINEAR_REGS),
                                                                    [enet] * len(CV_LINEAR_REGS), **cd))
    seq_cd_s = []
    for a, st in zip(CV_LINEAR_REGS, grid_cd):
        one, s = _timed(lambda: LR._solve_from_stats(stats, Xr.dtype, alpha=a, l1_ratio=enet, **cd))
        seq_cd_s.append(s)
        if int(one["n_iter_"]) != int(st["n_iter_"]) or int(st["n_iter_"]) != CV_LINEAR["maxIter"]:
            fail(f"10b: regParam {a}: batched CD ran {int(st['n_iter_'])} sweeps, sequential {int(one['n_iter_'])}")
        if not (torch.equal(one["coef_"], st["coef_"]) and torch.equal(one["intercept_"], st["intercept_"])):
            fail(f"10b: regParam {a}: batched CD coefficients differ from the sequential CD's; the bound is 0")
    timings["cd_grid_sweep_ms"] = grid_cd_s * 1e3 / CV_LINEAR["maxIter"]
    timings["cd_single_sweep_ms"] = float(np.mean(seq_cd_s)) * 1e3 / CV_LINEAR["maxIter"]
    del Xr, w0, yl, stats, grid_cd
    torch.cuda.empty_cache()
    say(f"  10b CrossValidator(LinearRegression({CV_LINEAR}), regParam {list(CV_LINEAR_REGS)} x elasticNetParam "
        f"{list(CV_LINEAR_ENETS)}, rmse): {timings['cv_linear_s']:.2f} s wall, placement "
        f"{timings['cv_linear_placement_s']:.2f} s, batched groups (cd, s) "
        f"{[(c, round(s, 2)) for c, s in calls]}; avgMetrics {[round(float(v), 6) for v in lcvm.avgMetrics]}; counters "
        f"{counts}; on fold 0's statistics (pass {timings['linear_stats_s']:.3f} s) one batched CD sweep of "
        f"{len(CV_LINEAR_REGS)} points {timings['cd_grid_sweep_ms']:.1f} ms against "
        f"{timings['cd_single_sweep_ms']:.1f} ms for one point alone, n_iter_ and coefficients equal bit for bit")

    # 10c: TrainValidationSplit, one OWL-QN group ---------------------------
    telemetry.registry().reset()
    tvs_est = LogisticRegression(**TVS_OWLQN)
    tgrid = ParamGridBuilder().addGrid(tvs_est.getParam("elasticNetParam"), list(TVS_ENETS)).build()
    tvs = TrainValidationSplit(estimator=tvs_est, estimatorParamMaps=tgrid, evaluator=acc, trainRatio=TVS_RATIO,
                               seed=TVS_SEED, collectSubModels=True)
    tvsm, timings["tvs_owlqn_s"] = _timed(lambda: tvs.fit(data))
    counts, _ = _engine_counters()
    _check_counters("10c", counts, {"ingest.datasets": 1, "fit.device_dataset_builds": 1,
                                    "fit.device_dataset_reuses": 1, "fit.solves_batched": len(tgrid),
                                    "fit.solves_sequential": 1})
    perm = np.random.default_rng(TVS_SEED).permutation(N_ROWS)
    tmask = np.zeros(N_ROWS, np.float32)
    tmask[perm[:int(round(TVS_RATIO * N_ROWS))]] = 1.0
    tseq, _ = _masked_models(tvs_est, data, tgrid, tmask)
    zeros = []
    for e, b, s in zip(TVS_ENETS, tvsm.subModels, tseq):
        if b.n_iter_ != s.n_iter_ or not np.array_equal(b.coef_ == 0.0, s.coef_ == 0.0):
            fail(f"10c: elasticNetParam {e}: n_iter_ {b.n_iter_} / {s.n_iter_} or the zero pattern differs "
                 "from the single fit's")
        zeros.append(int((b.coef_ == 0.0).sum()))
    if not any(zeros):
        fail("10c: no exact zero in the OWL-QN models")
    diff = max(float(np.abs(b.coef_ - s.coef_).max()) for b, s in zip(tvsm.subModels, tseq))
    torch.cuda.empty_cache()
    say(f"  10c TrainValidationSplit(LogisticRegression({TVS_OWLQN}), elasticNetParam {list(TVS_ENETS)}, "
        f"trainRatio {TVS_RATIO}): {timings['tvs_owlqn_s']:.2f} s wall, validation accuracy "
        f"{[round(float(v), 6) for v in tvsm.validationMetrics]}; counters {counts}; exact zeros {zeros} of {N_COLS} in the "
        f"same places as the single fits', n_iter_ {[m.n_iter_ for m in tvsm.subModels]}; coefficients apart by "
        f"{diff}")
    telemetry.disable()
    telemetry.registry().reset()

    # 10d: KMeans.fitMultiple over k ----------------------------------------
    telemetry.enable()
    km = KMeans(**KMEANS_MULTI)
    kmaps = [{km.getParam("k"): k} for k in KMEANS_MULTI_K]
    kdata = {"features": X}
    _kernels.reset_launches()
    torch.cuda.synchronize()
    multi, timings["kmeans_fit_multiple_s"] = _timed(
        lambda: [m for _, m in sorted(km.fitMultiple(kdata, kmaps), key=lambda im: im[0])])
    launch_counts = dict(_kernels.launches)  # read just after the fit_multiple run
    counts, _ = _engine_counters()
    telemetry.disable()
    telemetry.registry().reset()
    if counts["ingest.datasets"] != 1 or counts["fit.solves_sequential"] != len(kmaps):
        fail(f"10d: fitMultiple made {counts['ingest.datasets']} ingests and {counts['fit.solves_sequential']} "
             "solves, expected 1 and 2")
    for kernel in ("assign_argmin/f32", "assign_accumulate/f32"):
        if not launch_counts[kernel]:
            fail(f"10d: fit_multiple never launched {kernel}")
    single_s = []
    for k, m in zip(KMEANS_MULTI_K, multi):
        one, s = _timed(lambda: km.copy({km.getParam("k"): k}).fit(kdata))
        single_s.append(s)
        if m.cluster_centers_.shape != (k, N_COLS) or not np.isfinite(m.cluster_centers_).all() \
                or not np.isfinite(m.inertia_):
            fail(f"10d: k={k}: centers or inertia not finite of shape ({k}, {N_COLS})")
        if not (np.array_equal(m.cluster_centers_, one.cluster_centers_) and m.n_iter_ == one.n_iter_):
            fail(f"10d: k={k}: the fitMultiple model differs from the single fit")
        if not np.array_equal(np.asarray(m.transform(kdata)["prediction"]),
                              np.asarray(one.transform(kdata)["prediction"])):
            fail(f"10d: k={k}: the fitMultiple model's transform differs from the single fit's")
    timings["kmeans_single_fit_s"] = single_s
    say(f"  10d KMeans({KMEANS_MULTI}).fitMultiple over k {list(KMEANS_MULTI_K)}: "
        f"{timings['kmeans_fit_multiple_s']:.2f} s wall for both (one placement) against single fits "
        f"{', '.join(f'{s:.2f}' for s in single_s)} s; centers and transforms equal the single fits' bit for bit; "
        "launches in fit_multiple: " + ", ".join(f"{k_}={v}" for k_, v in launch_counts.items() if v))

    # 10e: the small input against the CPU ---------------------------------
    _small_tuning_reference()
    torch.cuda.empty_cache()
    return launch_counts, timings


def _small_tuning_reference():
    """10e: on 9a's 20000 x 40 input, CrossValidator over
    RandomForestClassifier through the per-model fallback on the card and
    on the CPU (the same avgMetrics, the same best forest bit for bit), and
    a Pipeline(PCA(k=3), LogisticRegression) fit, transform, save and load
    on the card (the loaded pipeline's output equal bit for bit)."""
    from spark_rapids_ml_tpu_torch import (PCA, CrossValidator, LogisticRegression, MulticlassClassificationEvaluator,
                                           ParamGridBuilder, Pipeline, PipelineModel, RandomForestClassifier,
                                           set_devices)

    rng = np.random.default_rng(17)
    n, d = RF_SMALL
    x = rng.standard_normal((n, d)).astype(np.float32)
    y3 = np.argmax(x[:, :3] + 0.7 * rng.standard_normal((n, 3)), axis=1).astype(np.float32)
    data = {"features": x, "label": y3}
    rf = RandomForestClassifier(**RF_SMALL_FOREST)
    grid = ParamGridBuilder().addGrid(rf.getParam("maxDepth"), list(SMALL_CV_GRID["maxDepth"])).build()
    out = {}
    for device in ("cpu", "cuda"):
        set_devices(device)
        out[device] = CrossValidator(estimator=rf, estimatorParamMaps=grid, numFolds=2, seed=CV_SEED,
                                     evaluator=MulticlassClassificationEvaluator(metricName="accuracy")).fit(data)
    set_devices(None)
    if out["cpu"].avgMetrics != out["cuda"].avgMetrics or not _same_forest(out["cpu"].bestModel,
                                                                           out["cuda"].bestModel):
        fail(f"10e: CrossValidator over the forest: avgMetrics {out['cuda'].avgMetrics} on the card, "
             f"{out['cpu'].avgMetrics} on the CPU, or the best forests differ")
    pipe = Pipeline(stages=[PCA(k=3, inputCol="features", outputCol="pcs"),
                            LogisticRegression(maxIter=50, featuresCol="pcs")])
    model = pipe.fit(data)
    got = model.transform(data)
    path = ROOT / "build" / "chip_smoke_pipeline"
    model.write().overwrite().save(str(path))
    again = PipelineModel.load(str(path)).transform(data)
    for col in ("pcs", "probability", "prediction"):
        if not np.array_equal(np.stack(got[col].to_numpy()), np.stack(again[col].to_numpy())):
            fail(f"10e: the loaded pipeline's {col} differs from the fitted one's")
    say(f"  10e, {n} x {d}: CrossValidator over RandomForestClassifier({RF_SMALL_FOREST}, maxDepth "
        f"{list(SMALL_CV_GRID['maxDepth'])}, 2 folds, the per-model fallback): avgMetrics "
        f"{[round(float(v), 6) for v in out['cuda'].avgMetrics]} on the card and the CPU, the best forest equal bit for "
        "bit; Pipeline(PCA(k=3), LogisticRegression) fit, transform, save and load: the loaded pipeline's output "
        "equals the fitted one's bit for bit")


# ----------------------------------------------------------- phase 11 ----


# benchmark/bench_approximate_nearest_neighbors.py:17-26: k = 64, 4096
# queries, nlist 256, nprobe 16, CAGRA degree 64/128 from ivf_pq, itopk 64;
# IVFPQ at M = 8, n_bits = 8 and the estimator's refine_ratio 4
ANN_CONFIGS = (
    ("ivfflat", {"nlist": 256, "nprobe": 16}),
    ("ivfpq", {"nlist": 256, "nprobe": 16, "M": 8, "n_bits": 8, "refine_ratio": 4}),
    # CAGRA's NN-descent cut from 3 rounds to 1, its clustered seeding from
    # 8 repetitions to 2, for the script's time
    ("cagra", {"graph_degree": 64, "intermediate_graph_degree": 128, "build_algo": "ivf_pq", "itopk_size": 64,
               "nn_descent_niter": 1, "cluster_reps": 2}),
)
ANN_PQ_TRAIN_ROWS = 65536  # build_ivfpq's train_cap
ANN_RECALL_FLOOR = {"ivfflat": 0.85}  # IVFPQ's and CAGRA's are printed, held on the CPU and card = CPU


@contextlib.contextmanager
def _call_timer(module, name, box, info=None):
    """Times each call of `module.name`, waited for on the card: appends
    (name, s, info(args, out)) to `box`."""
    import torch

    real = getattr(module, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        box.append((name, time.perf_counter() - t0, info(a, out) if info else None))
        return out

    setattr(module, name, timed)
    try:
        yield box
    finally:
        setattr(module, name, real)


def _ann_build_split(algo, box, build_s):
    """The build's parts from the timed calls: IVF seeding, Lloyd (the coarse
    fit), PQ training (codebook seeding and fits), encoding, layout (the
    rest: placement, assignment, lists); CAGRA seeding reps, merge, reverse
    edges, each descent round with its n_new, the rest."""
    split = {}
    for name, s, info in box:
        if name == "kmeans_fit":
            key = "lloyd_s" if info["rows"] == N_ROWS else "pq_train_s"
        elif name == "_kmeanspp_device":
            # the PQ codebooks' seeding on the training sample; the coarse
            # seeding's own reduce is inside scalable_kmeans_init_device
            key = "pq_train_s" if info["rows"] == ANN_PQ_TRAIN_ROWS else None
        else:
            key = {"scalable_kmeans_init_device": "seeding_s", "_encode_residuals": "encode_s",
                   "_cluster_seed_rep": "seed_reps_s", "_merge_dedup_topk": "merge_s",
                   "_reverse_edges": "reverse_edges_s"}.get(name)
        if key:
            split[key] = split.get(key, 0.0) + s
    if algo == "cagra":
        split["rounds"] = [{"s": s, "n_new": info} for name, s, info in box if name == "_descent_round"]
        split["seed_rep_s"] = [s for name, s, _ in box if name == "_cluster_seed_rep"]
        split["rest_s"] = build_s - sum(v for k_, v in split.items() if k_.endswith("_s") and k_ != "seed_rep_s") \
            - sum(r["s"] for r in split["rounds"])
    else:
        split["layout_s"] = build_s - sum(split.values())
    return split


def phase_ann(dev, X, exact_ids, exact_dist):
    """Phase 11: ApproximateNearestNeighbors at full width through the public
    API, on the float32 protocol rows after phase 10: IVFFlat, IVFPQ and
    CAGRA as ANN_CONFIGS gives them (one NN-descent round, two seeding
    repetitions); the first 4096 rows as
    queries, k = 64, phase 4's exact ids and distances the reference. Gates,
    fixed before the first run on the card: every returned id a row or -1
    where short, distances finite and ascending per row where an id is
    found; IVFFlat finds every query itself first with recall@64 >= 0.85;
    the launch counters show B1 f32, B1 f32-fast, B2 f32-fast and B3 f32
    moving and no float64 form. Returns (launch counts of the phase, its
    timings)."""
    import torch

    from spark_rapids_ml_tpu_torch import ApproximateNearestNeighbors
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import cagra as CG
    from spark_rapids_ml_tpu_torch.ops import kmeans as KM
    from spark_rapids_ml_tpu_torch.ops import knn as KN

    say(f"phase 11: ApproximateNearestNeighbors, {KNN_QUERIES} queries x {N_ROWS} x {N_COLS} float32, k = {KNN_K}")
    timings = {}
    totals = {key: 0 for key in _kernels.launches}
    queries = {"features": X[:KNN_QUERIES]}
    q64 = X[:KNN_QUERIES].astype(np.float64)
    rows_info = lambda a, out: {"rows": int(a[0].shape[0])}  # noqa: E731
    for algo, ap in ANN_CONFIGS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        box = []
        with contextlib.ExitStack() as stack:
            for module, name, info in (
                (KM, "scalable_kmeans_init_device", None), (KM, "kmeans_fit", rows_info),
                (KM, "_kmeanspp_device", rows_info), (KN, "_encode_residuals", None),
                (CG, "_cluster_seed_rep", None), (CG, "_merge_dedup_topk", None), (CG, "_reverse_edges", None),
                (CG, "_descent_round", lambda a, out: int(out[2])),
            ):
                stack.enter_context(_call_timer(module, name, box, info))
            _kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = ApproximateNearestNeighbors(k=KNN_K, algorithm=algo, algoParams=ap) \
                .setInputCol("features").fit({"features": X})
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        t0 = time.perf_counter()
        _, _, knn_df = model.kneighbors(queries)
        search_s = time.perf_counter() - t0
        counts = dict(_kernels.launches)  # read just after the path
        for key, v in counts.items():
            totals[key] += v
        t = {"build_s": build_s, "search_s": search_s, "queries_per_s": KNN_QUERIES / search_s,
             "peak_memory_gb": peak_gb, **_ann_build_split(algo, box, build_s)}
        say(f"  {algo} {ap}: build {build_s:.2f} s, peak memory {peak_gb:.2f} GB; search {search_s:.3f} s "
            f"({t['queries_per_s']:.0f} queries/s)")
        say("    build split: " + json.dumps({k_: v for k_, v in t.items()
                                                if k_ not in ("build_s", "search_s", "queries_per_s")}))
        say("    launches: " + ", ".join(f"{k_}={v}" for k_, v in counts.items() if v))
        if algo != "cagra":
            if algo == "ivfflat":
                lens = np.diff(model._index["offsets"].numpy())
            else:
                lens = (model._index["bucket_ids"] >= 0).sum(1).cpu().numpy()
            L = int(lens.max())
            t.update(L=L, fill=N_ROWS / (len(lens) * L),
                     padded_lists_gb=len(lens) * L * N_COLS * 4 / 1e9)
            say(f"    lists: L = {L} (largest), smallest {int(lens.min())}, fill n/(n_lists L) = {t['fill']:.4f}; "
                f"padded [{len(lens)}, {L}, {N_COLS}] float32 buckets would take {t['padded_lists_gb']:.2f} GB "
                f"(the port stores the IVFFlat lists unpadded: {N_ROWS * N_COLS * 4 / 1e9:.2f} GB)")

        ids = np.stack(knn_df["indices"].to_numpy())
        dist = np.stack(knn_df["distances"].to_numpy())
        if ids.shape != (KNN_QUERIES, KNN_K) or dist.shape != ids.shape:
            fail(f"{algo}: indices {ids.shape}, distances {dist.shape}")
        found = ids >= 0
        if ((ids < -1) | (ids >= N_ROWS)).any():
            fail(f"{algo}: ids outside [-1, {N_ROWS})")
        if not np.isfinite(dist[found]).all() or np.isfinite(dist[~found]).any():
            fail(f"{algo}: a found id without a finite distance, or a pad with one")
        if (np.diff(np.where(found, dist, np.inf), axis=1) < 0).any():
            fail(f"{algo}: distances not ascending")
        recall = float(np.mean([len(set(a[a >= 0]) & set(b)) / KNN_K for a, b in zip(ids, exact_ids)]))
        kth = ids[:, -1]
        ok = kth >= 0
        true_kth = np.sqrt(((X[kth[ok]].astype(np.float64) - q64[ok]) ** 2).sum(1))
        ratio = float(np.mean(true_kth / exact_dist[ok, -1]))
        t.update(recall_at_64=recall, kth_distance_ratio=ratio, short_rows=int((~found).any(1).sum()),
                 self_first=float(np.mean(ids[:, 0] == np.arange(KNN_QUERIES))))
        say(f"    recall@{KNN_K} {recall:.4f}; found k-th neighbour's true distance / exact k-th distance "
            f"{ratio:.6f} (mean over {int(ok.sum())} queries); {t['short_rows']} queries short of k; "
            f"self first {t['self_first']:.4f}")
        if algo == "ivfflat" and t["self_first"] != 1.0:
            fail(f"ivfflat: {int((ids[:, 0] != np.arange(KNN_QUERIES)).sum())} queries do not find themselves first")
        if recall < ANN_RECALL_FLOOR.get(algo, 0.0):
            fail(f"{algo}: recall@{KNN_K} {recall:.4f} below {ANN_RECALL_FLOOR[algo]}")
        if any(v for k_, v in counts.items() if "/f64" in k_):
            fail(f"{algo}: a float64 form launched: {counts}")
        timings[algo] = t
        del model, knn_df
        torch.cuda.empty_cache()
    for name in ("assign_argmin/f32", "assign_argmin/f32-fast", "assign_accumulate/f32-fast", "d2_block/f32"):
        if not totals[name]:
            fail(f"phase 11 never launched {name}")
    say("  launches in phase 11: " + ", ".join(f"{k_}={v}" for k_, v in totals.items() if v))
    return totals, timings


# ----------------------------------------------------------- phase 12 ----

# benchmark/benchmark_runner.py's protocol for DBSCAN and UMAP, nothing cut:
# bench_dbscan.py (20 blob centres, eps 1.5 sqrt(d), min_samples 5,
# max_mbytes_per_batch 512) and bench_umap.py (10 centres, n_neighbors 15,
# n_epochs 200, random_state 42; fit, then transform of every row)
DBSCAN_ROWS, DBSCAN_COLS, DBSCAN_CENTERS = 40_000, 64, 20
DBSCAN_EPS, DBSCAN_MIN_SAMPLES, DBSCAN_MBYTES = 1.5 * float(np.sqrt(64)), 5, 512
DBSCAN_ARI_FLOOR = 0.99
DBSCAN_INT_ROWS = 4000  # the card against the CPU, exactly
UMAP_ROWS, UMAP_COLS, UMAP_CENTERS = (20_000, 100_000), 64, 10
MP_UMAP_ROWS = UMAP_ROWS[0]  # phase 18e's rows (see MP_SHARE)
UMAP_K, UMAP_EPOCHS, UMAP_SEED = 15, 200, 42
UMAP_TW_ROWS, UMAP_TW_FLOOR = 2000, 0.90  # bench_umap.py's quality: the first 2000 rows
UMAP_LAYOUT_ATOL = 1e-3  # tests/test_torch_umap.py's layout tolerance (coordinates of scale 10)


def make_blobs(n, d, centers, seed):
    """sklearn's make_blobs law without sklearn (not on the card's
    machine): centres uniform in [-10, 10]^d, unit standard deviation,
    groups of n // centers rows (the first n % centers one row more), rows
    shuffled. Returns (float32 rows, int64 labels)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10.0, 10.0, size=(centers, d))
    labels = np.repeat(np.arange(centers), [n // centers + (i < n % centers) for i in range(centers)])
    x = c[labels] + rng.standard_normal((n, d))
    perm = rng.permutation(n)
    return x[perm].astype(np.float32), labels[perm].astype(np.int64)


def adjusted_rand_index(truth, pred):
    """sklearn.metrics.adjusted_rand_score in numpy (its pair confusion
    form; -1 is a label like any other)."""
    _, ti = np.unique(truth, return_inverse=True)
    _, pi = np.unique(pred, return_inverse=True)
    C = np.zeros((ti.max() + 1, pi.max() + 1), np.int64)
    np.add.at(C, (ti, pi), 1)
    n = int(len(truth))
    sum_squares = int((C * C).sum())
    n_c, n_k = C.sum(1), C.sum(0)
    c01 = int((C.T @ n_c).sum()) - sum_squares
    c10 = int((C @ n_k).sum()) - sum_squares
    tp, fp, fn = sum_squares - n, c01, c10
    tn = n * n - c01 - c10 - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def trustworthiness(x, emb, k):
    """sklearn.manifold.trustworthiness (euclidean) in numpy: 1 - 2/(n k (2n
    - 3k - 1)) times the sum over every row's k nearest in the embedding,
    not among its k nearest in x, of (rank in x) - k."""
    def order(a):
        a = a.astype(np.float64)
        sq = (a * a).sum(1)
        d = sq[:, None] + sq[None, :] - 2.0 * (a @ a.T)
        np.fill_diagonal(d, np.inf)
        return np.argsort(d, axis=1, kind="stable")

    n = len(x)
    rank = np.empty((n, n), np.int64)
    rank[np.arange(n)[:, None], order(x)] = np.arange(1, n + 1)[None, :]
    ranks = rank[np.arange(n)[:, None], order(emb)[:, :k]] - k
    return 1.0 - float(ranks[ranks > 0].sum()) * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def _dbscan_int_rows(n, d, seed):
    """Integer-valued rows: blobs of {-1, 0, 1} offsets around integer
    centres, and 5% uniform integer rows as noise. Every squared distance
    is an exact integer in float32."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-6, 7, size=(8, d))
    x = c[rng.integers(0, 8, n)] + rng.integers(-1, 2, size=(n, d))
    noise = rng.random(n) < 0.05
    x[noise] = rng.integers(-12, 13, size=(int(noise.sum()), d))
    return x.astype(np.float32)


def _eps_in_a_gap(dist, target, margin):
    """The eps nearest `target` with no pairwise distance within `margin`
    of it, so no pair can flip at eps in any float32 summation order."""
    v = np.unique(dist[np.triu_indices(len(dist), 1)])
    for step in range(1, 100000):
        for eps in (target + step * margin, target - step * margin):
            i = np.searchsorted(v, eps)
            near = min(abs(v[max(i - 1, 0)] - eps), abs(v[min(i, len(v) - 1)] - eps))
            if near > margin:
                return float(eps)
    fail("no gap in the pairwise distances")


def _dbscan_card_vs_cpu(dev):
    """12a's exact check: on DBSCAN_INT_ROWS integer rows, euclidean (eps^2
    a half-integer), cosine (eps in a gap of the float64 distances 1e-4
    wide) and precomputed (the squared-distance matrix, eps a
    half-integer), at the default tile and at a 1 MB budget, labels and
    core indices of the card equal to the CPU's exactly."""
    from spark_rapids_ml_tpu_torch import DBSCAN, set_devices
    from spark_rapids_ml_tpu_torch.utils import unit_rows

    x = _dbscan_int_rows(DBSCAN_INT_ROWS, DBSCAN_COLS, 5)
    x64 = x.astype(np.float64)
    sq = (x64 * x64).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x64 @ x64.T)  # exact integers
    u = unit_rows(x).astype(np.float64)
    cases = (
        ("euclidean", x, float(np.sqrt(60.5)), 5),
        ("cosine", x, _eps_in_a_gap(1.0 - u @ u.T, 0.05, 1e-4), 5),
        ("precomputed", d2.astype(np.float32), 60.5, 5),
    )
    out = {}
    for metric, rows, eps, ms in cases:
        for budget in (None, 1):
            labels = {}
            for device in ("cpu", dev):
                set_devices(device)
                try:
                    m = DBSCAN(eps=eps, min_samples=ms, metric=metric, max_mbytes_per_batch=budget) \
                        .setFeaturesCol("features").fit({"features": rows})
                    labels[str(device)] = (m.transform({"features": rows})["prediction"].to_numpy(),
                                           m.core_sample_indices_)
                finally:
                    set_devices(None)
            (lc, cc), (lg, cg) = labels["cpu"], labels[str(dev)]
            tag = f"DBSCAN {metric}, eps {eps:.6g}, budget {budget} MB"
            if not (np.array_equal(lc, lg) and np.array_equal(cc, cg)):
                fail(f"{tag}: the card's labels or core indices differ from the CPU's at "
                     f"{int((lc != lg).sum())} rows")
            out[f"{metric}/{budget}"] = {"clusters": int(lg.max()) + 1, "noise": float(np.mean(lg == -1)),
                                         "core": int(len(cg))}
    say(f"  {DBSCAN_INT_ROWS} x {DBSCAN_COLS} integer rows, euclidean / cosine / precomputed at the default "
        f"tile and 1 MB: the card's labels and core indices equal the CPU's exactly: {json.dumps(out)}")
    return out


def _umap_card_vs_cpu(dev, x, layout_epochs=5):
    """12b's stage checks at the smaller size, on the same rows: the kNN
    graph through B3 against the CPU's plain route (ids equal but where two
    distances tie within the float32 bound; distances within it), the
    smooth kNN and fuzzy weights of the CPU's graph on the card against the
    CPU (rtol 1e-5, atol 1e-6: tests/test_torch_umap.py's), and
    `layout_epochs` SGD epochs from the same Y0 and weights within
    UMAP_LAYOUT_ATOL."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import umap as UM

    cpu = torch.device("cpu")
    xc = torch.from_numpy(x)
    ci, cd = UM.build_knn_graph(xc, UMAP_K)
    gi, gd = UM.build_knn_graph(xc.to(dev), UMAP_K)
    bound = 8 * x.shape[1] * 2.0 ** -24 * float((x.astype(np.float64) ** 2).sum(1).max())
    err = np.abs(gd.astype(np.float64) ** 2 - cd.astype(np.float64) ** 2).max()
    if err > bound:
        fail(f"UMAP graph: the card's squared distances differ from the CPU's by {err} > {bound}")
    swapped = np.argwhere(gi != ci)
    for r, j in swapped:
        exact = float(((x[r].astype(np.float64) - x[gi[r, j]]) ** 2).sum())
        if abs(exact - float(cd[r, j]) ** 2) > bound:
            fail(f"UMAP graph: row {r} column {j}: the card's id {gi[r, j]} is not a near-tie of the CPU's {ci[r, j]}")
    out = {"graph_d2_err": float(err), "graph_d2_bound": bound, "graph_ids_swapped": int(len(swapped))}

    def stages(device):
        d, i = torch.from_numpy(cd).to(device), torch.from_numpy(ci.astype(np.int64)).to(device)
        rho, sigma = UM.smooth_knn(d)
        return rho.cpu().numpy(), sigma.cpu().numpy(), UM.fuzzy_simplicial_set(i, d, rho, sigma).cpu().numpy()

    for name, a, b in zip(("rho", "sigma", "fuzzy"), stages(cpu), stages(dev)):
        if not np.allclose(b, a, rtol=1e-5, atol=1e-6):
            fail(f"UMAP {name}: the card differs from the CPU beyond rtol 1e-5, atol 1e-6")
        out[f"{name}_bitwise"] = bool(np.array_equal(a, b))
        out[f"{name}_max_abs_diff"] = float(np.abs(a - b).max())
    w = stages(cpu)[2]
    a, b = UM.find_ab_params(1.0, 0.1)
    n = len(x)
    Y0 = np.random.default_rng(0).uniform(-10, 10, (n, 2)).astype(np.float32)
    w_opt = np.where(w >= w.max() / float(UMAP_EPOCHS), w, 0.0).astype(np.float32)
    inv, ov = UM._inverse_adjacency(ci, n)
    hubs, table = UM._overflow_gather(ci.reshape(-1).astype(np.int64), ov)

    def layout(device):
        t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)  # noqa: E731
        y0 = t(Y0)
        return UM.optimize_embedding(
            y0, y0, t(ci.astype(np.int64)), t(w_opt), t(inv), (t(hubs.astype(np.int64)), t(table)),
            n_epochs=layout_epochs, a=a, b=b, seed=UMAP_SEED,
        ).cpu().numpy()

    err = float(np.abs(layout(dev) - layout(cpu)).max())
    if err > UMAP_LAYOUT_ATOL:
        fail(f"UMAP {layout_epochs}-epoch layout: the card differs from the CPU by {err} > {UMAP_LAYOUT_ATOL}")
    out["layout_max_abs_diff"] = err
    say(f"  UMAP stages at {n} rows, the card against the CPU: " + json.dumps(out))
    return out


def phase_dbscan_umap(dev):
    """Phase 12: DBSCAN and UMAP at benchmark/benchmark_runner.py's protocol
    sizes through the public API, on rows this phase makes from a seed
    (`make_blobs`). Gates, fixed before the first run on the card: 12a
    DBSCAN on 40000 x 64 rows finds the generating blobs with ARI >= 0.99
    and launches no kernel, and on integer rows the card equals the CPU
    exactly (`_dbscan_card_vs_cpu`); 12b UMAP at 20000 and 100000 x 64
    rows: an embedding of finite values of shape [n, 2] and the transform
    of every row the same, trustworthiness of the first 2000 rows >= 0.90,
    the fit repeated equal bit for bit, B3 f32 launched by the fit and the
    transform exactly as the row and item tiles say and no other kernel
    form; the graph through B3 against the plain route on the same
    resident rows (ids equal on integer rows; squared distances within
    the float32 bound on the blobs) and, at 20000 rows, the stages against
    the CPU (`_umap_card_vs_cpu`). Returns (launch counts by run, timings,
    phase 18's references: 12a's labels and core rows, 12b's 100000-row
    embedding, transform and model)."""
    import torch

    from spark_rapids_ml_tpu_torch import DBSCAN, UMAP
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import dbscan as DB
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops import umap as UM

    say(f"phase 12: DBSCAN ({DBSCAN_ROWS} x {DBSCAN_COLS}) and UMAP ({' and '.join(map(str, UMAP_ROWS))} x "
        f"{UMAP_COLS}) at the benchmark protocol's sizes")
    timings, counts, refs = {}, {}, {}

    # 12a: DBSCAN
    x, y = make_blobs(DBSCAN_ROWS, DBSCAN_COLS, DBSCAN_CENTERS, 0)
    box = []
    with contextlib.ExitStack() as stack:
        for name, info in (("core_mask", None), ("core_components", lambda a, out: int(out[1])),
                           ("border_assign", None)):
            stack.enter_context(_call_timer(DB, name, box, info))
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = DBSCAN(eps=DBSCAN_EPS, min_samples=DBSCAN_MIN_SAMPLES, max_mbytes_per_batch=DBSCAN_MBYTES) \
            .setFeaturesCol("features").fit({"features": x})
        labels = model.transform({"features": x})["prediction"].to_numpy()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    counts["dbscan"] = dict(_kernels.launches)  # read just after the path
    if any(counts["dbscan"].values()):
        fail(f"DBSCAN launched a kernel: {counts['dbscan']}")
    ari = adjusted_rand_index(y, labels)
    t = {"transform_s": total, "ari": ari, "noise_share": float(np.mean(labels == -1)),
         "clusters": int(labels.max()) + 1, "core_rows": int(len(model.core_sample_indices_)),
         "tile_rows": DB._tile_rows_for_budget(DBSCAN_ROWS, DBSCAN_MBYTES)}
    for name, s, info in box:
        t[f"{name}_s"] = s
        if info is not None:
            t["rounds"] = info
    t["host_s"] = total - sum(s for _, s, _ in box)
    say(f"  12a DBSCAN eps {DBSCAN_EPS} min_samples {DBSCAN_MIN_SAMPLES}, {DBSCAN_MBYTES} MB tiles of "
        f"{t['tile_rows']} rows: {total:.3f} s (core pass {t['core_mask_s']:.3f}, components "
        f"{t['core_components_s']:.3f} in {t['rounds']} rounds, border {t['border_assign_s']:.3f}, host "
        f"{t['host_s']:.3f}); {t['clusters']} clusters, {t['core_rows']} core rows, noise share "
        f"{t['noise_share']:.5f}; ARI {ari:.6f}; no kernel launched")
    if ari < DBSCAN_ARI_FLOOR:
        fail(f"DBSCAN: ARI {ari} against the generating blobs below {DBSCAN_ARI_FLOOR}")
    t["card_vs_cpu"] = _dbscan_card_vs_cpu(dev)
    timings["dbscan"] = t
    refs.update(dbscan_labels=labels, dbscan_core=model.core_sample_indices_)
    del model

    # 12b: UMAP
    stage_names = ("build_knn_graph", "smooth_knn", "fuzzy_simplicial_set", "spectral_init", "optimize_embedding")
    counts["umap_fit"] = {key: 0 for key in _kernels.launches}
    counts["umap_transform"] = {key: 0 for key in _kernels.launches}
    for n in UMAP_ROWS:
        x, y = make_blobs(n, UMAP_COLS, UMAP_CENTERS, 0)
        est = UMAP(n_neighbors=UMAP_K, n_epochs=UMAP_EPOCHS, random_state=UMAP_SEED).setFeaturesCol("features")
        box = []
        with contextlib.ExitStack() as stack:
            for name in stage_names:
                stack.enter_context(_call_timer(UM, name, box))
            _kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = est.fit({"features": x})
            fit_s = time.perf_counter() - t0
            fit_counts = dict(_kernels.launches)  # read just after the fit
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.transform({"features": x})
        torch.cuda.synchronize()
        tr_s = time.perf_counter() - t0
        tr_counts = dict(_kernels.launches)  # read just after the transform
        # query tiles x item blocks: every row is a query and an item
        expected = -(-n // D.tile_rows()) * -(-n // D._DEFAULT_K_TILE)
        for run, c in (("fit", fit_counts), ("transform", tr_counts)):
            if c["d2_block/f32"] != expected or any(v for k_, v in c.items() if k_ != "d2_block/f32"):
                fail(f"UMAP {run} at {n} rows: launches {c}, expected d2_block/f32 = {expected} and nothing else")
            for key, v in c.items():
                counts[f"umap_{run}"][key] += v
        emb = model.embedding_
        emb_t = np.stack(out["embedding"].to_list())
        if emb.shape != (n, 2) or emb_t.shape != (n, 2) or not (np.isfinite(emb).all() and np.isfinite(emb_t).all()):
            fail(f"UMAP at {n} rows: embedding {emb.shape}, transform {emb_t.shape}, or a non-finite value")
        tw = trustworthiness(x[:UMAP_TW_ROWS], emb[:UMAP_TW_ROWS], UMAP_K)
        if tw < UMAP_TW_FLOOR:
            fail(f"UMAP at {n} rows: trustworthiness {tw} below {UMAP_TW_FLOOR}")
        split = {name: sum(s for nm, s, _ in box if nm == name) for name in stage_names}
        t = {"fit_s": fit_s, "transform_s": tr_s, "trustworthiness": tw, "b3_launches": expected,
             **{f"{k_}_s": v for k_, v in split.items()},
             "sgd_ms_per_epoch": split["optimize_embedding"] / UMAP_EPOCHS * 1e3,
             "transform_epochs": UMAP_EPOCHS // 3}
        t["fit_host_s"] = fit_s - sum(split.values())
        say(f"  12b UMAP {n} x {UMAP_COLS}: fit {fit_s:.3f} s = kNN graph {split['build_knn_graph']:.3f} "
            f"({expected} B3 f32 launches) + smooth kNN {split['smooth_knn']:.3f} + fuzzy set "
            f"{split['fuzzy_simplicial_set']:.3f} + spectral init {split['spectral_init']:.3f} + SGD "
            f"{split['optimize_embedding']:.3f} ({t['sgd_ms_per_epoch']:.2f} ms an epoch x {UMAP_EPOCHS}) + "
            f"host {t['fit_host_s']:.3f}; transform of {n} rows {tr_s:.3f} s ({t['transform_epochs']} epochs); "
            f"trustworthiness of the first {UMAP_TW_ROWS} rows {tw:.5f}")
        if n == UMAP_ROWS[0]:  # the repeat at the first size only, for the script's time
            again = est.fit({"features": x})
            if not np.array_equal(again.embedding_, emb):
                fail(f"UMAP at {n} rows: a second fit on the card differs from the first "
                     f"(max {np.abs(again.embedding_ - emb).max()})")
            say("    a second fit equals the first bit for bit")
            del again
        if n == MP_UMAP_ROWS:  # phase 18e's reference
            refs.update(umap_embedding=emb, umap_transform=emb_t, umap_model=model)
        del model, out
        # B3 against the plain route on the same resident rows
        Xd = torch.from_numpy(x).to(dev)
        res, secs = _knn_routes(Xd, None, Xd, UMAP_K)
        (dk, ik), (dp, ip) = res["kernel"], res["plain"]
        bound = 8 * UMAP_COLS * 2.0 ** -24 * float((x.astype(np.float64) ** 2).sum(1).max())
        err = float(np.abs(dk.astype(np.float64) ** 2 - dp.astype(np.float64) ** 2).max())
        if err > bound:
            fail(f"UMAP graph at {n} rows: B3 and the plain route differ by {err} > {bound} in squared distance")
        Xi = torch.round(Xd)  # integer rows: every sum exact, so the routes agree exactly
        res_i, _ = _knn_routes(Xi, None, Xi, UMAP_K)
        if not (np.array_equal(res_i["kernel"][1], res_i["plain"][1])
                and np.array_equal(res_i["kernel"][0], res_i["plain"][0])):
            fail(f"UMAP graph at {n} rows, integer rows: B3 and the plain route differ")
        t.update(graph_kernel_s=secs["kernel"], graph_plain_s=secs["plain"], graph_d2_err=err,
                 graph_d2_bound=bound, graph_ids_differing=int((ik != ip).sum()))
        say(f"    the graph on resident rows: B3 route {', '.join(f'{s:.3f}' for s in secs['kernel'])} s, plain "
            f"{', '.join(f'{s:.3f}' for s in secs['plain'])} s; squared distances within {err:.4g} (bound "
            f"{bound:.4g}), {t['graph_ids_differing']} ids differ (near-ties); integer rows: equal exactly")
        del Xd, Xi, res, res_i
        if n == UMAP_ROWS[0]:
            t["card_vs_cpu"] = _umap_card_vs_cpu(dev, x)
        timings[f"umap_{n}"] = t
        torch.cuda.empty_cache()
    say("  launches in phase 12: DBSCAN none; UMAP fits " + ", ".join(
        f"{k_}={v}" for k_, v in counts["umap_fit"].items() if v) + "; transforms " + ", ".join(
        f"{k_}={v}" for k_, v in counts["umap_transform"].items() if v))
    return counts, timings, refs


# ----------------------------------------------------------- phase 13 ----

# Phase 13's settings: the budget that demotes the 12 GB fits (8 GiB; the
# admission keeps 10% headroom, so ~7.7 GB), the allocator cap of 13c under
# which the 12 GB placement fails for real (the retry sizes its chunks
# against what the allocator can hand out under it), the depth of the
# streamed fits, and the global row of 13d's NaN (in the third chunk).
OOCORE_BUDGET = 8 << 30
OOCORE_CAP = 10 << 30
OOCORE_KMEANS_ITERS = 2  # cut from 3 for the script's time
OOCORE_LOGREG = {"regParam": 1e-5, "elasticNetParam": 0.0, "maxIter": 1, "tol": 1e-30}  # cut from 10
OOCORE_NAN_AT = (700_001, 17)


def _sleep_cycles_per_ms():
    """Cycles of torch.cuda._sleep that last one millisecond on this card."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    return 100_000_000 / start.elapsed_time(end)


def _held_on_card(min_bytes=1 << 26):
    """The CUDA tensors of at least `min_bytes` that the process still
    references after a collection, largest first: (bytes, shape, what
    refers to them, and what refers to that), a leak's trail."""
    import gc

    import torch

    gc.collect()
    found = []
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda and o.untyped_storage().nbytes() >= min_bytes:
            trail = []
            for r in gc.get_referrers(o)[:4]:
                up = [type(u).__name__ + (f":{u.f_code.co_name}" if hasattr(u, "f_code") else "")
                      for u in gc.get_referrers(r)[:4]]
                trail.append((type(r).__name__, up))
            found.append((o.untyped_storage().nbytes(), tuple(o.shape), trail))
    return sorted(found, key=lambda f: -f[0])[:8]


def phase_oocore(dev, X, linear_ref, y_cls):
    """Phase 13: the out-of-core fits at full width on the float32 protocol
    rows (12 GB), after every earlier phase's tensors left the card.
    13a the double-buffered pipeline alone: streamed chunks equal to one
    placement bit for bit, a pass's rate against the pinned copy's, and the
    overlap fraction with a caller whose work per chunk outlasts a copy;
    13b demotion by budget (config["hbm_budget_bytes"] = 8 GiB, the chunk
    sized by the admission): KMeans (k=1000, random init, high and fast),
    PCA(k=3), OLS and LogisticRegression streamed and held to their
    resident fits (KMeans bit for bit; PCA and OLS: phase 7a's, within its
    Weyl, Davis-Kahan and normwise bounds), B1 and B2 launched by exactly
    the tiles the chunks imply; 13c a real torch.OutOfMemoryError under an
    allocator cap turned into one streamed retry at the defaults (its chunk
    sized against the allocator's room) equal to 13b's model, and a RandomForest's into
    HbmBudgetError naming its largest term; 13d a NaN row named by
    IngestValidationError. Returns (launches of the streamed fits, timings)."""
    import gc

    import torch

    from spark_rapids_ml_tpu_torch import (KMeans, LinearRegression, LogisticRegression, PCA,
                                           RandomForestClassifier, memory, telemetry)
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.data import extract_dataset
    from spark_rapids_ml_tpu_torch.errors import HbmBudgetError, IngestValidationError
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops.streaming import _ranges
    from spark_rapids_ml_tpu_torch.parallel import StreamStaging, place_rows, stream_place_blocks

    say("phase 13: out-of-core fits at full width")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  on the card before the phase: {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated, "
        f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB reserved")
    timings, counts = {}, {}
    saved = {k: config[k] for k in ("hbm_budget_bytes", "stream_chunk_rows", "validate_ingest")}
    was_on = telemetry.enabled()
    telemetry.enable()
    reg = telemetry.registry()
    data = {"features": X}

    def gauges():
        return reg.snapshot()["gauges"]

    def counter(name):
        return int(reg.snapshot()["counters"].get(name, 0))

    try:
        # ---- 13a: the pipeline ------------------------------------------
        config["hbm_budget_bytes"] = OOCORE_BUDGET
        adm = memory.admit_fit(PCA(k=PCA_K), extract_dataset(data, input_col="features"), dev)
        memory.release_admission(adm)
        if adm.verdict != memory.STREAM:
            fail(f"13a: the admission of the 12 GB rows under {OOCORE_BUDGET} bytes gave {adm.verdict}")
        chunk = adm.chunk_rows
        ranges = _ranges(N_ROWS, chunk)
        say(f"  13a: budget {OOCORE_BUDGET} bytes: {adm.verdict}, {chunk} rows a chunk, {len(ranges)} chunks a "
            f"pass ({chunk * N_COLS * 4 / 1e9:.2f} GB each; estimate {adm.estimate.total()} bytes, largest "
            f"{adm.estimate.largest()})")
        (Xd, _), timings["place_rows_s"] = _timed(lambda: place_rows(X, device=dev))
        staging = StreamStaging()

        def blocks():
            return ({"X": X[lo:hi]} for lo, hi in ranges)

        def check_pass():
            # a function, so no chunk outlives the pass in a local
            equal = 0
            for i, blk in enumerate(stream_place_blocks(blocks(), device=dev, staging=staging)):
                lo, hi = ranges[i]
                equal += bool(torch.equal(blk["X"], Xd[lo:hi]))
            return equal

        equal, timings["first_pass_s"] = _timed(check_pass)  # the staging buffers allocated in it
        check_overlap = gauges()["ingest.overlap_fraction"]
        del Xd
        torch.cuda.empty_cache()
        if equal != len(ranges):
            fail(f"13a: {len(ranges) - equal} of {len(ranges)} streamed chunks differ from one place_rows")

        def bare_pass():
            for _ in stream_place_blocks(blocks(), device=dev, staging=staging):
                pass
            torch.cuda.synchronize()

        _, timings["pass_s"] = _timed(bare_pass)
        # the copy rates alone, on one chunk: host memory into a page-locked
        # buffer, and the page-locked buffer to the card
        pinned, dbuf = staging.buffers(0, "X", X[:chunk], dev)
        src = torch.from_numpy(X[:chunk])
        _, timings["host_to_pinned_s"] = _timed(lambda: pinned.copy_(src))
        timings["pinned_h2d_ms"] = cuda_ms(lambda: dbuf.copy_(pinned, non_blocking=True), reps=3)
        gbs = X.nbytes / timings["pass_s"] / 1e9
        h2p = chunk * N_COLS * 4 / timings["host_to_pinned_s"] / 1e9
        p2d = chunk * N_COLS * 4 / timings["pinned_h2d_ms"] * 1e3 / 1e9
        # a caller whose work on a chunk lasts 1.5 chunk transfers: each next
        # chunk's copy should be done when it is asked for
        per_chunk_ms = timings["pass_s"] * 1e3 / len(ranges)
        cycles = int(1.5 * per_chunk_ms * _sleep_cycles_per_ms())

        def busy_pass():
            for _ in stream_place_blocks(blocks(), device=dev, staging=staging):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()

        _, timings["busy_pass_s"] = _timed(busy_pass)
        busy_overlap = gauges()["ingest.overlap_fraction"]
        del staging, pinned, dbuf, src
        say(f"  13a: {len(ranges)} streamed chunks equal one place_rows of the rows bit for bit (overlap "
            f"{check_overlap:.3f} in that pass, the caller's work a torch.equal); placing all rows at once "
            f"{timings['place_rows_s']:.2f} s; a pass {timings['pass_s']:.3f} s = {gbs:.2f} GB/s, against "
            f"{h2p:.2f} GB/s host to page-locked and {p2d:.2f} GB/s page-locked to the card on one chunk alone")
        say(f"  13a: with {1.5 * per_chunk_ms:.0f} ms of card work a chunk the pass took "
            f"{timings['busy_pass_s']:.3f} s ({len(ranges)} x {1.5 * per_chunk_ms / 1e3:.3f} s of work + "
            f"{timings['pass_s']:.3f} s of transfer unhidden = "
            f"{len(ranges) * 1.5 * per_chunk_ms / 1e3 + timings['pass_s']:.3f} s), ingest.overlap_fraction "
            f"{busy_overlap:.3f} (at most {(len(ranges) - 1) / len(ranges):.3f})")
        if not busy_overlap > 0:
            fail("13a: ingest.overlap_fraction is 0 on a multi-chunk pass whose caller outlasts the copies")

        # ---- 13b: demotion by budget ------------------------------------
        def streamed(name, make, fit_data, passes):
            config["hbm_budget_bytes"] = OOCORE_BUDGET
            config["stream_chunk_rows"] = 0
            d0 = counter("fit.demotions")
            _kernels.reset_launches()
            m, secs = _timed(lambda: make().fit(fit_data))
            counts[name] = {k: n for k, n in _kernels.launches.items() if n}
            config["hbm_budget_bytes"] = None
            adm = m._fit_metrics["admission"]
            if adm["verdict"] != "stream" or counter("fit.demotions") != d0 + 1:
                fail(f"13b {name}: not demoted once (verdict {adm['verdict']}, fit.demotions "
                     f"{counter('fit.demotions') - d0})")
            timings[f"{name}_stream_fit_s"] = secs
            gc.collect()
            left = torch.cuda.memory_allocated(dev)
            if left > 1 << 30:
                fail(f"13b {name}: {left} bytes still allocated on the card after the streamed fit: "
                     f"{_held_on_card()}")
            n_passes = passes(m)
            say(f"  13b {name}: streamed {secs:.2f} s, {n_passes} passes ({secs / n_passes:.3f} s a pass) of "
                f"{len(_ranges(N_ROWS, adm['chunk_rows']))} chunks of {adm['chunk_rows']} admitted rows, "
                f"estimate {adm['estimate_bytes']} bytes (largest {adm['largest_term']}), overlap "
                f"{gauges().get('ingest.overlap_fraction', 0.0):.3f}, launches {counts[name] or 'none'}")
            return m, adm

        def resident(name, make, fit_data):
            config["hbm_budget_bytes"] = None
            m, secs = _timed(lambda: make().fit(fit_data))
            timings[f"{name}_resident_fit_s"] = secs
            return m

        first_tiles = {}

        def recording(tag):
            """Record the assignments of the fit's first pass, tile by
            tile."""
            real = D.assign_argmin
            tiles = first_tiles.setdefault(tag, [])

            def spy(xb, centers, fast=False):
                out = real(xb, centers, fast=fast)
                if sum(len(t) for t in tiles) < N_ROWS:
                    tiles.append(out[1].cpu())
                return out

            return real, spy

        km = {}
        for mode, extra in (("high", {"distance_precision": "high"}), ("fast", {"solver_precision": "bf16"})):
            def make_km(extra=extra):
                return KMeans(k=K, maxIter=OOCORE_KMEANS_ITERS, tol=1e-20, initMode="random", seed=1, **extra)

            for where in ("resident", "stream"):
                real, spy = recording(f"{mode}/{where}")
                D.assign_argmin = spy
                try:
                    if where == "resident":
                        km[(mode, where)] = resident(f"kmeans_{mode}", make_km, data), None
                    else:
                        km[(mode, where)] = streamed(f"kmeans_{mode}", make_km, data, lambda m: m.n_iter_ + 1)
                finally:
                    D.assign_argmin = real
            res, (st, adm_km) = km[(mode, "resident")][0], km[(mode, "stream")]
            # B1 and B2: every streamed pass runs the resident loop's tiles
            # (whole Lloyd tiles per chunk); the in-loop passes at the
            # mode's variant, the final inertia pass at f32
            rounded = adm_km["chunk_rows"] // TILE_ROWS * TILE_ROWS if adm_km["chunk_rows"] > TILE_ROWS \
                else adm_km["chunk_rows"]
            tiles = sum(-(-(hi - lo) // TILE_ROWS) for lo, hi in _ranges(N_ROWS, rounded))
            loop = "f32-fast" if mode == "fast" else "f32"
            want = {}
            for kern in ("assign_argmin", "assign_accumulate"):
                want[f"{kern}/{loop}"] = want.get(f"{kern}/{loop}", 0) + st.n_iter_ * tiles
                want[f"{kern}/f32"] = want.get(f"{kern}/f32", 0) + tiles
            if counts[f"kmeans_{mode}"] != want:
                fail(f"13b kmeans {mode}: launches {counts[f'kmeans_{mode}']}, the chunks imply {want}")
            a, b = first_tiles[f"{mode}/stream"], first_tiles[f"{mode}/resident"]
            if not torch.equal(torch.cat(a), torch.cat(b)):
                fail(f"13b kmeans {mode}: the streamed first-iteration assignments differ from the resident ones")
            # the streamed step sums every chunk's tiles into one set of
            # accumulators on the card, in row order, with the resident
            # loop's kernels at its tiles: the same additions in the same
            # order, so the fits are equal bit for bit
            if not (np.array_equal(st.cluster_centers_, res.cluster_centers_) and st.inertia_ == res.inertia_
                    and st.n_iter_ == res.n_iter_):
                diff = np.abs(st.cluster_centers_ - res.cluster_centers_).max(axis=1)
                fail(f"13b kmeans {mode}: the streamed fit differs from the resident one: n_iter_ "
                     f"{st.n_iter_}/{res.n_iter_}, {int((diff > 0).sum())} of {K} centers apart (the largest by "
                     f"{float(diff.max())}), inertia {st.inertia_!r} vs {res.inertia_!r}")
            say(f"  13b kmeans {mode}: resident {timings[f'kmeans_{mode}_resident_fit_s']:.2f} s, streamed "
                f"{timings[f'kmeans_{mode}_stream_fit_s']:.2f} s; first-iteration assignments equal on all "
                f"{N_ROWS} rows ({len(a)} tiles streamed, {len(b)} resident); final centers, inertia "
                f"{st.inertia_:.6e} and n_iter_ {st.n_iter_} equal to the resident fit's bit for bit; launches as "
                f"the {tiles} tiles a pass imply")
        km_high = km[("high", "stream")][0]

        pca = streamed("pca", lambda: PCA(k=PCA_K).setInputCol("features"), data, lambda m: 2)
        ols = streamed("ols", lambda: LinearRegression(), {"features": X, "label": linear_ref["y"]},
                       lambda m: 1)[0]
        pca = pca[0]
        # held to phase 7a's resident fits by its bounds (each fit's float32
        # statistics and eigh or solve within F32_EIGH_REL / F32_SOLVE_REL of
        # exact, so the two within twice that)
        pca_res, ols_res, spectrum = linear_ref["pca"], linear_ref["ols"], linear_ref["spectrum"]
        pert = 2 * F32_EIGH_REL * float(pca_res.explained_variance_[0])
        ev_err = float(np.abs(pca.explained_variance_ - pca_res.explained_variance_).max())
        if ev_err > pert:
            fail(f"13b pca: explained variance within {ev_err} of the resident fit (Weyl bound {pert})")
        cosines = []
        for i in range(PCA_K):
            gap = min(abs(spectrum[i] - spectrum[j]) for j in range(PCA_K + 1) if j != i) - 2 * pert
            cos = abs(float(pca.components_[i].astype(np.float64) @ pca_res.components_[i]))
            cosines.append(cos)
            if gap > 0 and pert / gap < 1 and cos < np.sqrt(1 - (pert / gap) ** 2):
                fail(f"13b pca: component {i}: |cos| {cos} below the Davis-Kahan bound {np.sqrt(1 - (pert / gap) ** 2)}")
        kappa = float(spectrum[0] / spectrum[-1])
        rel = 2 * kappa * F32_SOLVE_REL / (1 - 2 * kappa * F32_SOLVE_REL)
        c_err = float(np.linalg.norm(ols.coef_ - ols_res.coef_) / np.linalg.norm(ols_res.coef_))
        if c_err > rel:
            fail(f"13b ols: coefficients {c_err} relative from the resident fit's (normwise bound {rel})")
        say(f"  13b pca and ols against phase 7a's resident fits: explained variance within {ev_err:.3g} (bound "
            f"{pert:.3g}), |cos| {[round(c, 9) for c in cosines]}; OLS coefficients within {c_err:.3g} relative "
            f"(bound {rel:.3g}, condition {kappa:.4g}), intercept {ols.intercept_:.6g} vs {ols_res.intercept_:.6g}")

        def make_lr():
            return LogisticRegression(**OOCORE_LOGREG)

        lr_data = {"features": X, "label": y_cls}
        lr_res = resident("logreg", make_lr, lr_data)
        lr, _ = streamed("logreg", make_lr, lr_data, lambda m: 2 + 2 * m.n_iter_)
        # the same iterations from the same start, the sums in another
        # order: the objective within 1e-5 relative, the coefficients within
        # 1e-3 (normwise) of the resident fit's
        f_err = abs(lr.objective_ - lr_res.objective_) / abs(lr_res.objective_)
        lc_err = float(np.linalg.norm(lr.coef_ - lr_res.coef_) / np.linalg.norm(lr_res.coef_))
        if lr.n_iter_ != lr_res.n_iter_ or f_err > 1e-5 or lc_err > 1e-3:
            fail(f"13b logreg: n_iter_ {lr.n_iter_}/{lr_res.n_iter_}, objective within {f_err} (tol 1e-5), "
                 f"coefficients within {lc_err} (tol 1e-3) of the resident fit")
        say(f"  13b logreg {OOCORE_LOGREG}: resident {timings['logreg_resident_fit_s']:.2f} s, streamed "
            f"{timings['logreg_stream_fit_s']:.2f} s; n_iter_ {lr.n_iter_}, objective {lr.objective_:.8g} vs "
            f"{lr_res.objective_:.8g} ({f_err:.3g} relative), coefficients within {lc_err:.3g}")
        for name in ("pca", "ols", "logreg"):
            if counts[name]:
                fail(f"13b {name}: a kernel was launched ({counts[name]}); this path runs none")

        # ---- 13c: the real OOM ladder -----------------------------------
        config["hbm_budget_bytes"] = None
        config["stream_chunk_rows"] = 0
        gc.collect()
        torch.cuda.empty_cache()
        if torch.cuda.memory_allocated(dev) > 1 << 30:
            fail(f"13c: {torch.cuda.memory_allocated(dev)} bytes allocated before the cap: {_held_on_card()}")
        total = torch.cuda.get_device_properties(dev).total_memory
        caught, d0 = counter("memory.oom_caught"), counter("fit.demotions")
        torch.cuda.set_per_process_memory_fraction(OOCORE_CAP / total, dev)
        try:
            retried, timings["oom_retry_fit_s"] = _timed(
                lambda: KMeans(k=K, maxIter=OOCORE_KMEANS_ITERS, tol=1e-20, initMode="random", seed=1,
                               distance_precision="high").fit(data))
            try:
                RandomForestClassifier(numTrees=2, maxDepth=4).fit(lr_data)
                fail("13c: a RandomForest fit over the cap did not raise")
            except HbmBudgetError as e:
                rf_err = e
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
        adm = retried._fit_metrics["admission"]
        if counter("memory.oom_caught") != caught + 2 or counter("fit.demotions") != d0 + 1:
            fail(f"13c: memory.oom_caught advanced by {counter('memory.oom_caught') - caught} (expected 2: the "
                 f"KMeans and the RandomForest placements), fit.demotions by {counter('fit.demotions') - d0}")
        if adm["verdict"] != "stream" or not adm["reason"].startswith("backend OOM"):
            fail(f"13c: the retry's admission is {adm}")
        if not (np.array_equal(retried.cluster_centers_, km_high.cluster_centers_)
                and retried.inertia_ == km_high.inertia_ and retried.n_iter_ == km_high.n_iter_):
            fail("13c: the retried KMeans model differs from 13b's streamed one")
        if rf_err.largest_term != "placement.X" or not isinstance(rf_err.__cause__, torch.OutOfMemoryError):
            fail(f"13c: the RandomForest's error names {rf_err.largest_term}, caused by {type(rf_err.__cause__)}")
        say(f"  13c: allocator capped at {OOCORE_CAP} bytes: KMeans's 12 GB placement raised "
            f"torch.OutOfMemoryError, caught and retried once streamed ({timings['oom_retry_fit_s']:.2f} s; "
            f"{adm['chunk_rows']} admitted rows a chunk, estimate {adm['estimate_bytes']} bytes, {adm['reason']}), "
            f"equal to 13b's streamed model bit for bit; RandomForestClassifier raised HbmBudgetError naming "
            f"{rf_err.largest_term} ({rf_err.largest_term_bytes} bytes)")

        # ---- 13d: validation --------------------------------------------
        config["hbm_budget_bytes"] = OOCORE_BUDGET
        config["stream_chunk_rows"] = 0
        config["validate_ingest"] = True
        row, col = OOCORE_NAN_AT
        kept = X[row, col]
        X[row, col] = np.nan
        try:
            LinearRegression().fit({"features": X, "label": linear_ref["y"]})
            fail("13d: a NaN row did not raise IngestValidationError in a streamed fit")
        except IngestValidationError as e:
            if (e.column, e.row) != ("features", row):
                fail(f"13d: IngestValidationError names {e.column!r} row {e.row}, not 'features' row {row}")
            say(f"  13d: a NaN at row {row} of a streamed fit raised IngestValidationError: {e}")
        finally:
            X[row, col] = kept
    finally:
        config.update(saved)
        if not was_on:
            telemetry.disable()
    counts["oocore"] = {}
    for name in ("kmeans_high", "kmeans_fast"):
        for key, n in counts[name].items():
            counts["oocore"][key] = counts["oocore"].get(key, 0) + n
    return counts, timings



# ----------------------------------------------------------- phase 14 ----

# Phase 14's sizes: the reference's tests_large sparse shape (bench.py's
# sparse_logreg lane), nothing cut; 14a's slice for the card-against-CPU
# check and the holdout rows; the regParam grid of 14a and 14d; 14b's
# slice held to the densified dense fit; 14c's budget, below the ~1.1 GB
# of the resident ELL tensors; 14d's rows; 14e's item set and queries.
SPARSE_ROWS, SPARSE_COLS, SPARSE_DENSITY = 10_000_000, 2200, 0.001
SPARSE_LOGREG = {"regParam": 1e-6, "standardization": True, "maxIter": 60, "tol": 1e-12}
SPARSE_SLICE_ROWS = 200_000
# 14a's slice fitted on the card and the CPU (cut from 200,000 for the script's time)
SPARSE_CPU_SLICE_ROWS = 100_000
SPARSE_GRID = (1e-6, 1e-5, 1e-4, 1e-3)
SPARSE_LINEAR = (("ols", {"regParam": 0.0}), ("ridge", {"regParam": 1e-5}),
                 ("cd", {"regParam": 1e-5, "elasticNetParam": 0.5, "maxIter": 10, "tol": 1e-30}))
SPARSE_DENSE_ROWS = 500_000
SPARSE_STREAM_BUDGET = 1 << 30
SPARSE_STREAM_LOGREG = dict(SPARSE_LOGREG, maxIter=1)  # cut from 10
SPARSE_CV_ROWS = 250_000  # cut from 1,000,000 for the script's time
# 14e's items: 500,000 rows (cut from 1,000,000 for the script's time)
SPARSE_KNN_ROWS, SPARSE_KNN_DENSITY, SPARSE_KNN_QUERIES, SPARSE_KNN_K = 500_000, 0.01, 4096, 64
SPARSE_KNN_TILE = 65536  # ops/knn.exact_knn_sparse's batch_items
KMEANSPAR_ROWS, KMEANSPAR_COLS, KMEANSPAR_K = 262_144, 128, 1000


def random_csr(rng, n_rows, n_cols, density, dtype=np.float32, values="uniform"):
    """An O(nnz) CSR draw, as benchmark/gen_data.py's random_csr makes it:
    per-row Binomial(n_cols, density) nonzeros, columns drawn with
    replacement (a row may hold a column twice), values uniform on [0, 1)
    or standard normal."""
    import scipy.sparse as sp

    nnz_row = rng.binomial(n_cols, density, size=n_rows).astype(np.int64)
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(nnz_row, out=indptr[1:])
    total = int(indptr[-1])
    indices = rng.integers(0, n_cols, size=total).astype(np.int32)
    if values == "normal":
        data = rng.normal(size=total).astype(dtype)
    else:
        data = rng.random(total, dtype=np.float32).astype(dtype)
    return sp.csr_matrix((data, indices, indptr), shape=(n_rows, n_cols))


def sparse_problem():
    """14a's rows and labels: (CSR x, float32 labels x·β + 0.25·ε > 0,
    β ~ N(0, 4²)), from default_rng(0)."""
    rng = np.random.default_rng(0)
    x = random_csr(rng, SPARSE_ROWS, SPARSE_COLS, SPARSE_DENSITY)
    coef_true = rng.normal(scale=4.0, size=SPARSE_COLS)
    y = ((np.asarray(x @ coef_true) + 0.25 * rng.normal(size=SPARSE_ROWS)) > 0).astype(np.float32)
    return x, y, coef_true


def sparse_linear_labels(x):
    """14b's labels of `x` (gen_sparse_regression_host's: support d/40,
    noise 0.01), from default_rng(1): (float32 labels, coefficients)."""
    rng_l = np.random.default_rng(1)
    coef_lin = np.zeros(SPARSE_COLS, dtype=np.float32)
    coef_lin[:max(1, SPARSE_COLS // 40)] = rng_l.normal(size=max(1, SPARSE_COLS // 40))
    y_lin = (np.asarray(x @ coef_lin) + 0.01 * rng_l.normal(size=SPARSE_ROWS)).astype(np.float32)
    return y_lin, coef_lin


def sparse_knn_problem():
    """14e's CSR items (normal values) and dense queries, from
    default_rng(2)."""
    rng_k = np.random.default_rng(2)
    items = random_csr(rng_k, SPARSE_KNN_ROWS, SPARSE_COLS, SPARSE_KNN_DENSITY, values="normal")
    queries = rng_k.normal(size=(SPARSE_KNN_QUERIES, SPARSE_COLS)).astype(np.float32)
    return items, queries


def _same_bits(a, b):
    """Two fitted LogisticRegression models equal bit for bit."""
    return (a.n_iter_ == b.n_iter_ and a.objective_ == b.objective_
            and np.array_equal(a.coef_, b.coef_) and np.array_equal(a.intercept_, b.intercept_))


def _hist_sum(name):
    from spark_rapids_ml_tpu_torch import telemetry

    return float(telemetry.summarize_histogram(name)["sum"] or 0.0)


def _kmeanspar_twice(dev):
    """A weighted k-means|| seeding (ops/kmeans.scalable_kmeans_init_device,
    the ANN builds' seeding) run twice on the same rows and weights: the
    candidate weights it reduces with (a float scatter-add) and the centers
    must repeat bit for bit."""
    import torch

    from spark_rapids_ml_tpu_torch.ops import kmeans as KM

    rng = np.random.default_rng(7)
    xd = torch.from_numpy(rng.normal(size=(KMEANSPAR_ROWS, KMEANSPAR_COLS)).astype(np.float32)).to(dev)
    sw = rng.uniform(0.5, 2.0, size=KMEANSPAR_ROWS).astype(np.float32)
    real = KM._kmeanspp_device
    runs = []

    def spy(x, w, seed, *, k):
        runs[-1]["weights"] = w.cpu().numpy()
        return real(x, w, seed, k=k)

    KM._kmeanspp_device = spy
    try:
        for _ in range(2):
            runs.append({})
            runs[-1]["centers"] = KM.scalable_kmeans_init_device(xd, KMEANSPAR_K, 3, sample_weight=sw).cpu().numpy()
    finally:
        KM._kmeanspp_device = real
    same_w = np.array_equal(runs[0]["weights"], runs[1]["weights"])
    same_c = np.array_equal(runs[0]["centers"], runs[1]["centers"])
    n_diff, n_w = int((runs[0]["weights"] != runs[1]["weights"]).sum()), runs[0]["weights"].size
    say(f"  14f weighted k-means|| seeding ({KMEANSPAR_ROWS} x {KMEANSPAR_COLS}, k={KMEANSPAR_K}) twice: candidate "
        f"weights differ in {n_diff} of {n_w}, centers {'equal' if same_c else 'differ'}")
    if not (same_w and same_c):
        fail("14f: a weighted k-means|| seeding does not repeat bit for bit on the card")
    return {"weights_equal": same_w, "centers_equal": same_c}


def phase_sparse(dev):
    """Phase 14: sparse input (CSR through the public entry points) at the
    reference's tests_large shape, 10,000,000 x 2200 at density 0.001,
    float32, from this script's O(nnz) generator. 14a LogisticRegression
    (regParam 1e-6, standardization, maxIter 60, tol 1e-12) on labels
    (x·β + 0.25·ε > 0), β ~ N(0, 4²): the conversion, placement and solve
    timed apart; accuracy on the first 200,000 rows >= 0.9 and the cosine
    to β >= 0.9 (tests/test_large_sparse.py's bars); a second fit bit for
    bit; a 4-point regParam grid (fitMultiple) against its single fits bit
    for bit; the same estimator on a 100,000-row slice on the card and the
    CPU, its predictions of the slice equal on 99.9% of rows (the fits
    stop on a stall at float32 noise, at iterations of their own), and
    at 10 iterations, tol 0 (both stop there): float32 objective rtol
    5e-5 and coefficients 1e-5 normwise (the float32 objective itself lies
    1.4e-5 from float64's on these rows, on the CPU), float64 coefficients
    within 1e-9 of the largest and objective rtol 1e-12. 14b
    LinearRegression on the same rows with gen_sparse_regression_host's
    labels (support d/40, noise 0.01): OLS, ridge and CD elastic net
    (maxIter 10), the statistics pass and the solve timed apart, OLS
    repeated bit for bit, and a 500,000-row slice's ELL OLS within 1e-4
    (normwise) of the densified slice's dense fit. 14c under a 1 GiB budget:
    LogisticRegression (maxIter 1, cut from 10) and OLS stream (verdict stream), held
    to their resident fits (logistic: n_iter_ equal, objective rtol 1e-5,
    coefficients 1e-3 normwise; OLS: 1e-4 normwise). 14d a 3-fold x 4-map
    CrossValidator over LogisticRegression (maxIter 20) on the first
    250,000 rows (cut from 1,000,000): one conversion, one ingest, one placement. 14e
    NearestNeighbors(k=64) over 500,000 x 2200 CSR items at density 0.01
    (normal values) for 4096 dense normal queries: every item tile's
    distances through B3 (d2_block/f32, 4 blocks a tile), the kernel route
    equal to the plain route (ids exactly, distances rtol 1e-5). 14f a
    weighted k-means|| seeding twice, bit for bit. Returns (launches of
    14e by kernel form, timings, phase 18's references: 14a's objective,
    14b's OLS, 14e's ids and distances)."""
    import gc

    import torch

    from spark_rapids_ml_tpu_torch import (CrossValidator, LinearRegression, LogisticRegression,
                                           MulticlassClassificationEvaluator, NearestNeighbors,
                                           ParamGridBuilder, set_devices, telemetry)
    from spark_rapids_ml_tpu_torch import core as C
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import distance as D
    from spark_rapids_ml_tpu_torch.ops import knn as KNN
    from spark_rapids_ml_tpu_torch.ops import linear as LIN
    from spark_rapids_ml_tpu_torch.ops import logistic as LG
    from spark_rapids_ml_tpu_torch.ops import sparse as SP

    say(f"phase 14: sparse input, {SPARSE_ROWS} x {SPARSE_COLS} CSR at density {SPARSE_DENSITY}")
    gc.collect()
    torch.cuda.empty_cache()
    timings, refs = {}, {}
    was_on = telemetry.enabled()
    telemetry.enable()
    reg = telemetry.registry()

    def counters():
        return reg.snapshot()["counters"]

    seconds, clock = {}, [None, time.perf_counter()]

    def lap(part):
        """Close the running subphase (its seconds printed and kept) and
        open `part`."""
        now = time.perf_counter()
        if clock[0] is not None:
            seconds[clock[0]] = now - clock[1]
            say(f"  [{clock[0]}: {seconds[clock[0]]:.1f} s]")
        clock[0], clock[1] = part, now

    try:
        lap("14 data")
        t0 = time.perf_counter()
        x, y, coef_true = sparse_problem()
        timings["data_s"] = time.perf_counter() - t0
        say(f"  data: {x.nnz} nonzeros, the widest row {int(np.diff(x.indptr).max())}, "
            f"{timings['data_s']:.2f} s")
        data = {"features": x, "label": y}

        # ---- 14a: LogisticRegression --------------------------------------
        lap("14a")
        reg.reset()
        box = []
        with _call_timer(LG, "logistic_fit_ell", box):
            m, fit_s = _timed(lambda: LogisticRegression(**SPARSE_LOGREG).fit(data))
        snap = reg.snapshot()
        k_max = int(snap["gauges"]["sparse.k_max"])
        ell_bytes = int(snap["counters"]["sparse.ell_bytes"])
        conv_s, place_s, solve_s = _hist_sum("host_section.ell_convert_s"), \
            _hist_sum("device_wait.ell_layout_s"), box[0][1]
        n_h = SPARSE_SLICE_ROWS
        pred = m.transform({"features": x[:n_h]})["prediction"].to_numpy()
        acc = float((pred == y[:n_h]).mean())
        coef = m.coef_.ravel()
        cos = float(coef @ coef_true / max(np.linalg.norm(coef) * np.linalg.norm(coef_true), 1e-30))
        refs["logreg_objective"] = m.objective_
        timings["logreg"] = dict(k_max=k_max, ell_bytes=ell_bytes, convert_s=conv_s, place_s=place_s,
                                 solve_s=solve_s, fit_s=fit_s, n_iter=m.n_iter_,
                                 ms_per_iter=1e3 * solve_s / max(1, m.n_iter_), objective=m.objective_,
                                 accuracy=acc, cosine=cos)
        say(f"  14a LogisticRegression {SPARSE_LOGREG}: k_max {k_max}, ELL {ell_bytes / 1e9:.3f} GB; conversion "
            f"{conv_s:.2f} s, placement {place_s:.3f} s, solve {solve_s:.2f} s ({m.n_iter_} iterations, "
            f"{timings['logreg']['ms_per_iter']:.2f} ms each), fit {fit_s:.2f} s; objective {m.objective_:.8g}; "
            f"accuracy on the first {n_h} rows {acc:.4f}, cosine to the true coefficients {cos:.4f}")
        if acc < 0.9 or cos < 0.9:
            fail(f"14a: accuracy {acc} or cosine {cos} below 0.9")
        # the solver's two products on the placed ELL, alone: X·b and Xᵀ·r,
        # each bound by reading the ELL once (values and int32 indices) and
        # its vector in and out
        idx_h, val_h, _ = SP.csr_to_ell(x, dtype=np.float32)
        val_d, idx_d = torch.from_numpy(val_h).to(dev), torch.from_numpy(idx_h).to(dev)
        del idx_h, val_h
        cols, cols_s = _timed(lambda: SP.EllColumns(val_d, idx_d, SPARSE_COLS))
        matvec, rmat = LG._ell_ops(val_d, idx_d, SPARSE_COLS, False, cols)
        b = torch.randn((SPARSE_COLS, 1), device=dev)
        r = torch.randn((SPARSE_ROWS, 1), device=dev)
        mv_ms, rm_ms = cuda_ms(lambda: matvec(b)), cuda_ms(lambda: rmat(r))
        prod_bound = 1e3 * (val_d.numel() * 8 + (SPARSE_ROWS + SPARSE_COLS) * 4) / PEAK_BYTES_S
        timings["logreg"].update(columns_build_s=cols_s, columns_bytes=cols.nbytes(), matvec_ms=mv_ms, rmat_ms=rm_ms,
                                 product_bound_ms=prod_bound)
        say(f"  14a the products on the placed ELL: X·b {mv_ms:.3f} ms, Xᵀ·r {rm_ms:.3f} ms, each bound by "
            f"{prod_bound:.3f} ms (bytes); the column grouping {cols_s:.3f} s to build, {cols.nbytes() / 1e9:.3f} GB")
        del val_d, idx_d, cols, matvec, rmat, b, r
        m2, fit2_s = _timed(lambda: LogisticRegression(**SPARSE_LOGREG).fit(data))
        if not _same_bits(m, m2):
            fail("14a: a second sparse LogisticRegression fit differs from the first")
        say(f"  14a a second fit ({fit2_s:.2f} s, its own conversion and placement): equal bit for bit")
        est = LogisticRegression(**SPARSE_LOGREG)
        maps = [{est.getParam("regParam"): v} for v in SPARSE_GRID]
        reg.reset()
        with C.device_dataset_scope():
            grid, grid_s = _timed(lambda: est.fit(data, maps))
            singles, singles_s = _timed(lambda: [est.copy(pm).fit(data) for pm in maps])
        c = counters()
        for v, gm, sm in zip(SPARSE_GRID, grid, singles):
            if not _same_bits(gm, sm):
                fail(f"14a: the batched grid's regParam={v} model differs from its single fit")
        if int(c.get("sparse.csr_to_ell_calls", 0)) != 1 or int(c.get("fit.solves_batched", 0)) != len(SPARSE_GRID):
            fail(f"14a: the grid and its single fits converted {c.get('sparse.csr_to_ell_calls')} times and "
                 f"batched {c.get('fit.solves_batched')} solves (want 1 and {len(SPARSE_GRID)})")
        timings["logreg_grid"] = dict(grid_s=grid_s, singles_s=singles_s, n_iter=[g.n_iter_ for g in grid])
        say(f"  14a regParam grid {SPARSE_GRID} through fitMultiple: {grid_s:.2f} s (n_iter_ "
            f"{[g.n_iter_ for g in grid]}), every model equal to its single fit bit for bit (4 fits "
            f"{singles_s:.2f} s, one placement)")
        del m2, grid, singles
        # the card against the CPU on a slice
        n_c = SPARSE_CPU_SLICE_ROWS
        xs, ys = x[:n_c], y[:n_c]
        slice_data = {"features": xs, "label": ys}
        res = {}
        ten = dict(SPARSE_LOGREG, maxIter=10, tol=0.0)  # tol 0: both stop after exactly 10 iterations
        for where in ("cuda", "cpu"):
            set_devices(where)
            try:
                full = LogisticRegression(**SPARSE_LOGREG).fit(slice_data)
                res[where] = (full, full.transform(slice_data)["prediction"].to_numpy(),
                              LogisticRegression(**ten).fit(slice_data),
                              LogisticRegression(**ten, float32_inputs=False).fit(slice_data))
            finally:
                set_devices(None)
        (g_full, p_g, g32, g64), (c_full, p_c, c32, c64) = res["cuda"], res["cpu"]
        agree = float((p_g == p_c).mean())
        f_full = abs(g_full.objective_ - c_full.objective_) / abs(c_full.objective_)
        f32_err = abs(g32.objective_ - c32.objective_) / abs(c32.objective_)
        c32_err = float(np.linalg.norm(g32.coef_ - c32.coef_) / np.linalg.norm(c32.coef_))
        scale = float(np.abs(c64.coef_).max())
        c64_err = float(np.abs(g64.coef_ - c64.coef_).max())
        f64_err = abs(g64.objective_ - c64.objective_) / abs(c64.objective_)
        timings["logreg_card_vs_cpu"] = dict(full_n_iter=[g_full.n_iter_, c_full.n_iter_], full_objective_rel=f_full,
                                             prediction_agreement=agree, f32_objective_rel=f32_err,
                                             f32_coef_rel=c32_err, f64_coef_err=c64_err, f64_objective_rel=f64_err)
        say(f"  14a on {n_c} rows, card against CPU: the fit as above stops after {g_full.n_iter_}/{c_full.n_iter_} "
            f"iterations (a stall at float32 noise), objectives {f_full:.3g} apart, predictions agree on {agree:.5f}; "
            f"10 iterations (tol 0): float32 objective within {f32_err:.3g}, coefficients {c32_err:.3g} (normwise); "
            f"float64 coefficients within {c64_err:.3g} (largest {scale:.4g}), objective within {f64_err:.3g}")
        if agree < 0.999:
            fail(f"14a: the card's and the CPU's slice fits predict alike on {agree} of the rows (want >= 0.999)")
        if g32.n_iter_ != c32.n_iter_ or f32_err > 5e-5 or c32_err > 1e-5:
            fail("14a: the float32 slice fit (10 iterations) differs between the card and the CPU beyond its bounds")
        if g64.n_iter_ != c64.n_iter_ or c64_err > 1e-9 * scale or f64_err > 1e-12:
            fail("14a: the float64 slice fit differs between the card and the CPU beyond its bounds")
        del res, g_full, c_full, g32, g64, c32, c64, m
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 14b: LinearRegression ----------------------------------------
        lap("14b")
        y_lin, coef_lin = sparse_linear_labels(x)
        lin_data = {"features": x, "label": y_lin}
        lin_models, lin_t = {}, {}
        with C.device_dataset_scope():
            for name, params in SPARSE_LINEAR:
                box = []
                with _call_timer(LIN, "_ell_sufficient_stats", box), _call_timer(LIN, "_solve_from_stats", box):
                    lin_models[name], fit_s = _timed(lambda: LinearRegression(**params).fit(lin_data))
                lin_t[name] = dict(fit_s=fit_s, stats_s=box[0][1], solve_s=box[1][1])
            again, _ = _timed(lambda: LinearRegression(**SPARSE_LINEAR[0][1]).fit(lin_data))
        if not (np.array_equal(again.coef_, lin_models["ols"].coef_) and again.intercept_ == lin_models["ols"].intercept_):
            fail("14b: a second sparse OLS fit differs from the first")
        ols = lin_models["ols"]
        refs.update(ols_coef=ols.coef_, ols_intercept=ols.intercept_)
        rel = float(np.linalg.norm(ols.coef_ - coef_lin) / np.linalg.norm(coef_lin))
        xd_s = x[:SPARSE_DENSE_ROWS]
        ell_s = LinearRegression(**SPARSE_LINEAR[0][1]).fit({"features": xd_s, "label": y_lin[:SPARSE_DENSE_ROWS]})
        dense_s = LinearRegression(**SPARSE_LINEAR[0][1]).fit(
            {"features": np.asarray(xd_s.todense()), "label": y_lin[:SPARSE_DENSE_ROWS]})
        d_err = float(np.linalg.norm(ell_s.coef_ - dense_s.coef_) / np.linalg.norm(dense_s.coef_))
        lin_t["slice_ell_vs_dense"] = d_err
        lin_t["ols_rel_to_truth"] = rel
        timings["linear"] = lin_t
        for name, _ in SPARSE_LINEAR:
            t = lin_t[name]
            say(f"  14b {name}: statistics pass {t['stats_s']:.2f} s, solve {t['solve_s']:.3f} s, fit {t['fit_s']:.2f} s, "
                f"n_iter_ {lin_models[name].n_iter_}")
        say(f"  14b OLS repeats bit for bit; coefficients {rel:.3g} (normwise) from the generating ones; on "
            f"{SPARSE_DENSE_ROWS} rows the ELL fit is within {d_err:.3g} of the densified dense fit")
        if d_err > 1e-4:
            fail(f"14b: the ELL OLS of the slice is {d_err} from the dense fit (bound 1e-4)")
        del again, ell_s, dense_s, xd_s
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 14c: streamed ------------------------------------------------
        lap("14c")
        stream_t = {}
        lr_res, res_s = _timed(lambda: LogisticRegression(**SPARSE_STREAM_LOGREG).fit(data))
        saved = {k: config[k] for k in ("hbm_budget_bytes", "stream_chunk_rows")}
        config.update(hbm_budget_bytes=SPARSE_STREAM_BUDGET, stream_chunk_rows=0)
        try:
            reg.reset()
            lr_st, st_s = _timed(lambda: LogisticRegression(**SPARSE_STREAM_LOGREG).fit(data))
            ols_st, ols_st_s = _timed(lambda: LinearRegression(**SPARSE_LINEAR[0][1]).fit(lin_data))
        finally:
            config.update(saved)
        adm, adm_l = lr_st._fit_metrics.get("admission", {}), ols_st._fit_metrics.get("admission", {})
        if adm.get("verdict") != "stream" or adm_l.get("verdict") != "stream":
            fail(f"14c: verdicts {adm.get('verdict')} and {adm_l.get('verdict')} under {SPARSE_STREAM_BUDGET} bytes "
                 "(want stream)")
        passes = 2 + 2 * lr_st.n_iter_
        f_err = abs(lr_st.objective_ - lr_res.objective_) / abs(lr_res.objective_)
        lc_err = float(np.linalg.norm(lr_st.coef_ - lr_res.coef_) / np.linalg.norm(lr_res.coef_))
        oc_err = float(np.linalg.norm(ols_st.coef_ - ols.coef_) / np.linalg.norm(ols.coef_))
        stream_t.update(logreg_resident_s=res_s, logreg_stream_s=st_s, logreg_chunk_rows=adm["chunk_rows"],
                        logreg_s_per_pass=st_s / passes, ols_stream_s=ols_st_s, ols_chunk_rows=adm_l["chunk_rows"],
                        logreg_objective_rel=f_err, logreg_coef_rel=lc_err, ols_coef_rel=oc_err)
        timings["stream"] = stream_t
        say(f"  14c budget {SPARSE_STREAM_BUDGET} bytes: LogisticRegression streamed in {adm['chunk_rows']}-row chunks, "
            f"{st_s:.2f} s ({passes} passes, {st_s / passes:.3f} s each) against {res_s:.2f} s resident; objective within "
            f"{f_err:.3g}, coefficients {lc_err:.3g}; OLS streamed in {adm_l['chunk_rows']}-row chunks, {ols_st_s:.2f} s, "
            f"coefficients {oc_err:.3g} from the resident fit")
        if lr_st.n_iter_ != lr_res.n_iter_ or f_err > 1e-5 or lc_err > 1e-3 or oc_err > 1e-4:
            fail("14c: a streamed sparse fit is beyond its bounds from the resident fit")
        del lr_res, lr_st, ols_st, lin_models, ols
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 14d: CrossValidator ------------------------------------------
        lap("14d")
        cv_data = {"features": x[:SPARSE_CV_ROWS], "label": y[:SPARSE_CV_ROWS]}
        cv_est = LogisticRegression(**dict(SPARSE_LOGREG, maxIter=20))
        cv_grid = ParamGridBuilder().addGrid(cv_est.getParam("regParam"), list(SPARSE_GRID)).build()
        reg.reset()
        cvm, cv_s = _timed(lambda: CrossValidator(
            estimator=cv_est, estimatorParamMaps=cv_grid, numFolds=3, seed=4,
            evaluator=MulticlassClassificationEvaluator(metricName="accuracy")).fit(cv_data))
        c = counters()
        want = {"sparse.csr_to_ell_calls": 1, "ingest.datasets": 1, "fit.device_dataset_builds": 1,
                "fit.solves_batched": 3 * len(SPARSE_GRID)}
        got = {k: int(c.get(k, 0)) for k in want}
        if got != want:
            fail(f"14d: CrossValidator counters {got}, want {want}")
        timings["cv"] = dict(cv_s=cv_s, avg_metrics=[float(v) for v in cvm.avgMetrics])
        say(f"  14d CrossValidator 3 folds x {len(SPARSE_GRID)} maps on {SPARSE_CV_ROWS} rows: {cv_s:.2f} s; "
            f"{got}; avgMetrics {[round(float(v), 5) for v in cvm.avgMetrics]}")
        del cvm, cv_data, data, lin_data, x, y, y_lin
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 14e: sparse exact kNN on B3 ----------------------------------
        lap("14e")
        t0 = time.perf_counter()
        items, queries = sparse_knn_problem()
        knn_gen_s = time.perf_counter() - t0
        model = NearestNeighbors(k=SPARSE_KNN_K).setInputCol("features").fit({"features": items})
        box = []
        _kernels.reset_launches()
        with _call_timer(KNN, "csr_to_ell", box), _call_timer(KNN, "ell_densify", box), \
                _call_timer(KNN, "topk_tile", box):
            (_, _, knn_df), knn_s = _timed(lambda: model.kneighbors({"features": queries}))
        launches = dict(_kernels.launches)
        tiles = -(-SPARSE_KNN_ROWS // SPARSE_KNN_TILE)
        want_l = tiles * -(-SPARSE_KNN_TILE // D._DEFAULT_K_TILE)
        if launches["d2_block/f32"] != want_l or sum(launches.values()) != want_l:
            fail(f"14e: launches {launches}, want {want_l} of d2_block/f32 and no other kernel")
        split = {name: sum(s for n_, s, _ in box if n_ == name) for name in ("csr_to_ell", "ell_densify", "topk_tile")}
        ids_k = np.stack(knn_df["indices"].to_numpy())
        dist_k = np.stack(knn_df["distances"].to_numpy())
        refs.update(knn_ids=ids_k, knn_dist=dist_k)
        Q = torch.from_numpy(queries).to(dev)
        kernel_block = D.d2_block
        D.d2_block = D.d2_block_plain
        try:
            (dist_p, ids_p), plain_s = _timed(lambda: KNN.exact_knn_sparse(items, Q, k=SPARSE_KNN_K))
        finally:
            D.d2_block = kernel_block
        if not np.array_equal(ids_k, ids_p) or not np.allclose(dist_k, dist_p, rtol=1e-5, atol=0.0):
            fail(f"14e: the kernel route and the plain route differ: {int((ids_k != ids_p).sum())} ids, distances "
                 f"within {float(np.max(np.abs(dist_k - dist_p) / np.maximum(np.abs(dist_p), 1e-30)))}")
        if not np.all(np.isfinite(dist_k)) or not np.all(np.diff(dist_k, axis=1) >= 0):
            fail("14e: distances not finite and ascending")
        timings["knn"] = dict(gen_s=knn_gen_s, kneighbors_s=knn_s, convert_s=split["csr_to_ell"],
                              densify_s=split["ell_densify"], merge_s=split["topk_tile"], plain_s=plain_s,
                              launches=launches["d2_block/f32"])
        say(f"  14e NearestNeighbors(k={SPARSE_KNN_K}) over {SPARSE_KNN_ROWS} x {SPARSE_COLS} CSR items (density "
            f"{SPARSE_KNN_DENSITY}, {items.nnz} nonzeros), {SPARSE_KNN_QUERIES} queries: kneighbors {knn_s:.2f} s "
            f"(tile conversion {split['csr_to_ell']:.2f} s, densify on the card {split['ell_densify']:.3f} s, "
            f"top-k merge through B3 {split['topk_tile']:.2f} s); {launches['d2_block/f32']} d2_block/f32 launches; the plain "
            f"route {plain_s:.2f} s, ids equal, distances within rtol 1e-5")
        del items, queries, Q, model, knn_df
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 14f: the k-means|| weights -----------------------------------
        lap("14f")
        timings["kmeanspar"] = _kmeanspar_twice(dev)
        lap(None)
        timings["seconds"] = seconds
    finally:
        if not was_on:
            telemetry.disable()
    return {"sparse_knn": launches}, timings, refs

# ----------------------------------------------------------- phase 16 ----

# Phase 16's fits: 16a/16b KMeans at the protocol's k with random centers
# (maxIter cut from 30 to 6, tol 0 so every iteration runs), its cadence and
# 16b's fault boundary; 16c LogisticRegression's two solvers, their cadence
# and fault boundary; 16e the streamed slice (cut from 1M rows: a streamed
# GLM iteration costs ~2 s at full size, PERF.md section 5), its budget and
# GLM.
RECOVERY_KMEANS = {"k": K, "maxIter": 6, "tol": 0.0, "initMode": "random", "seed": 1}
RECOVERY_KMEANS_EVERY, RECOVERY_OOM_AT = 2, 4
RECOVERY_OOM_CHUNK_ROWS = 300_000  # 16b's streamed retry: 13b's admitted chunk, 9 whole tiles
RECOVERY_LOGREG = (("glm_qn", {"regParam": 1e-5, "maxIter": 30, "tol": 1e-30}),
                   ("owlqn", {"regParam": 1e-4, "elasticNetParam": 0.5, "maxIter": 30}))
RECOVERY_LOGREG_EVERY, RECOVERY_LOGREG_FAULT_AT = 10, 20
RECOVERY_STREAM_ROWS, RECOVERY_STREAM_BUDGET = 200_000, 1 << 30
RECOVERY_STREAM_LOGREG = {"regParam": 1e-5, "maxIter": 6, "tol": 1e-30}
RECOVERY_STREAM_EVERY = 3


def _same_model(a, b, attrs):
    """Whether two models' attributes are equal bit for bit."""
    return all(np.array_equal(np.asarray(getattr(a, n)), np.asarray(getattr(b, n))) for n in attrs)


def phase_recovery(dev, X, linear_ref, y_cls, linear_timings):
    """Phase 16: recovery on the protocol rows (the module comment's list).
    Returns (the launches of the phase, timings, the unchecked fits phase 17
    is held to: 16a's KMeans by mode with their launches, 16c's GLM)."""
    import gc

    import torch

    from spark_rapids_ml_tpu_torch import KMeans, LinearRegression, LogisticRegression, PCA, telemetry
    from spark_rapids_ml_tpu_torch.core import config, device_dataset_scope
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import linear as LR
    from spark_rapids_ml_tpu_torch.ops import logistic as LG
    from spark_rapids_ml_tpu_torch.ops import pca as P
    from spark_rapids_ml_tpu_torch.parallel import chaos

    say(f"phase 16: recovery, {N_ROWS} x {N_COLS} float32")
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("checkpoint_every_iters", "fit_retry_backoff_s", "hbm_budget_bytes", "stream_chunk_rows")
    saved = {k_: config[k_] for k_ in keys}
    was_on = telemetry.enabled()
    telemetry.enable()
    reg = telemetry.registry()
    timings = {}
    refs = {"kmeans": {}, "kmeans_launches": {}}
    tiles = -(-N_ROWS // TILE_ROWS)
    _kernels.reset_launches()  # the recovery run's launches: every fit of the phase

    def fit(tag, make, data, *, every=0, plan=None):
        """One fit at a cadence under a fault plan: (model, the counters it
        moved, the kernel launches it made). Every plan entry must fire."""
        config["checkpoint_every_iters"] = every
        faults = chaos.set_fault_plan(plan) if plan else chaos.clear_fault_plan()
        c0, l0 = dict(reg.snapshot()["counters"]), dict(_kernels.launches)
        try:
            m, timings[tag] = _timed(lambda: make().fit(data))
        finally:
            chaos.clear_fault_plan()
            config["checkpoint_every_iters"] = 0
        if plan and not all(f.spent() for f in faults):
            fail(f"16 {tag}: the fault plan {plan!r} never fired")
        c1 = reg.snapshot()["counters"]
        moved = {k_: int(v - c0.get(k_, 0)) for k_, v in c1.items() if v != c0.get(k_, 0)}
        launched = {k_: n - l0.get(k_, 0) for k_, n in _kernels.launches.items() if n != l0.get(k_, 0)}
        return m, moved, launched

    def recovery_counters(moved):
        return {k_: v for k_, v in moved.items()
                if k_.startswith(("checkpoint.", "fit.retries", "memory.oom", "fit.demotions"))}

    def want_counters(tag, moved, **want):
        got = {k_: moved.get(k_, 0) for k_ in want}
        if got != want:
            fail(f"16 {tag}: counters {got}, expected {want}")

    config["fit_retry_backoff_s"] = 0.01
    try:
        # ---- 16a: KMeans, checkpointed and resumed, both modes ----------
        # one scope: the two modes share the placement (the dataset key has
        # no precision), so the 12 GB is placed once
        data = {"features": X}
        kmeans, fits = {}, {}
        with device_dataset_scope():
            for mode, extra in (("fast", {}), ("high", {"distance_precision": "high"})):
                def make(extra=extra):
                    return KMeans(**RECOVERY_KMEANS, **extra)

                plain, _, l_plain = fit(f"kmeans_{mode}_unchecked_s", make, data)
                ckpt, c_ckpt, l_ckpt = fit(f"kmeans_{mode}_checkpointed_s", make, data,
                                           every=RECOVERY_KMEANS_EVERY)
                res, c_res, l_res = fit(f"kmeans_{mode}_resumed_s", make, data, every=RECOVERY_KMEANS_EVERY,
                                        plan="fail:stage=solve:times=1")
                if mode == "high":
                    # ---- 16b: the OOM ladder's streamed retry resumes the
                    # resident checkpoint (the placement above is evicted
                    # by the ladder, the retry streams the same rows in
                    # chunks of 13b's size: on the emptied card it would
                    # admit all the rows as one chunk and cross no chunk
                    # boundary)
                    real, at_fault = chaos.maybe_fail_oom, {}

                    def spy(stage, index=0):
                        try:
                            real(stage, index)
                        except BaseException:
                            at_fault.update(index=index, launches=dict(_kernels.launches))
                            raise

                    chaos.maybe_fail_oom = spy
                    config["stream_chunk_rows"] = RECOVERY_OOM_CHUNK_ROWS
                    l_start = dict(_kernels.launches)
                    try:
                        oom, c_oom, l_oom = fit("kmeans_high_oom_retry_s", make, data,
                                                every=RECOVERY_KMEANS_EVERY,
                                                plan=f"oom:stage=solve:round={RECOVERY_OOM_AT}")
                    finally:
                        chaos.maybe_fail_oom = real
                        config["stream_chunk_rows"] = 0
                fits[mode] = (plain, ckpt, res, c_ckpt, c_res, l_plain, l_ckpt, l_res)
        gc.collect()
        torch.cuda.empty_cache()
        for mode, (plain, ckpt, res, c_ckpt, c_res, l_plain, l_ckpt, l_res) in fits.items():
            loop = "f32-fast" if mode == "fast" else "f32"
            n_iter = RECOVERY_KMEANS["maxIter"]
            want = {f"{kern}/{loop}": n_iter * tiles for kern in ("assign_argmin", "assign_accumulate")}
            for kern in ("assign_argmin", "assign_accumulate"):  # the final inertia pass, full precision
                want[f"{kern}/f32"] = want.get(f"{kern}/f32", 0) + tiles
            for tag, m in (("checkpointed", ckpt), ("resumed", res)):
                if not (_same_model(m, plain, ("cluster_centers_", "inertia_", "n_iter_"))):
                    diff = np.abs(m.cluster_centers_ - plain.cluster_centers_).max()
                    fail(f"16a kmeans {mode}: the {tag} fit differs from the unchecked one (centers by {diff}, "
                         f"inertia {m.inertia_!r} vs {plain.inertia_!r}, n_iter_ {m.n_iter_}/{plain.n_iter_})")
            n_saves = n_iter // RECOVERY_KMEANS_EVERY
            want_counters(f"kmeans {mode} checkpointed", c_ckpt, **{"checkpoint.saves": n_saves})
            want_counters(f"kmeans {mode} resumed", c_res, **{"fit.retries": 1, "checkpoint.restores": 1,
                                                              "checkpoint.saves": n_saves})
            if not (l_plain == l_ckpt == l_res == want):
                fail(f"16a kmeans {mode}: launches unchecked {l_plain}, checkpointed {l_ckpt}, resumed {l_res}; "
                     f"{n_iter} iterations and the final inertia over {tiles} tiles imply {want}")
            kmeans[mode] = plain
            refs["kmeans"][mode], refs["kmeans_launches"][mode] = plain, l_plain
            say(f"  16a kmeans {mode}: unchecked {timings[f'kmeans_{mode}_unchecked_s']:.2f} s (placement "
                f"{'included' if mode == 'fast' else 'reused'}), checkpointed every {RECOVERY_KMEANS_EVERY} "
                f"{timings[f'kmeans_{mode}_checkpointed_s']:.2f} s, resumed after `fail:stage=solve` at iteration "
                f"{RECOVERY_KMEANS_EVERY} {timings[f'kmeans_{mode}_resumed_s']:.2f} s; the three equal bit for bit "
                f"(inertia {plain.inertia_:.6e}, n_iter_ {plain.n_iter_}); resumed counters "
                f"{recovery_counters(c_res)}; launches {l_res} in each of the three, no iteration twice")

        # 16b's checks
        resident_part = {k_: n - l_start.get(k_, 0) for k_, n in at_fault.get("launches", {}).items()
                         if n != l_start.get(k_, 0)}
        streamed_part = {k_: n - resident_part.get(k_, 0) for k_, n in l_oom.items()}
        n_after = RECOVERY_KMEANS["maxIter"] - RECOVERY_OOM_AT + 1  # iterations 5-6 and the final inertia
        want_res = {f"{kern}/f32": RECOVERY_OOM_AT * tiles for kern in ("assign_argmin", "assign_accumulate")}
        want_str = {f"{kern}/f32": n_after * tiles for kern in ("assign_argmin", "assign_accumulate")}
        if at_fault.get("index") != RECOVERY_OOM_AT:
            fail(f"16b: the injected OOM fired at {at_fault.get('index')}, not at the iteration-{RECOVERY_OOM_AT} "
                 "boundary")
        want_counters("kmeans oom", c_oom, **{"memory.oom_caught": 1, "fit.demotions": 1, "checkpoint.restores": 1})
        if oom._fit_metrics["admission"]["verdict"] != "stream" or not (
                oom._fit_metrics["admission"]["chunk_rows"] < N_ROWS):
            fail(f"16b: the retry's admission is {oom._fit_metrics['admission']}: not streamed in several chunks")
        if resident_part != want_res or streamed_part != want_str:
            fail(f"16b: launches resident {resident_part} (want {want_res}), streamed {streamed_part} (want "
                 f"{want_str})")
        # 13b holds a streamed KMeans fit to the resident one bit for bit
        # (whole Lloyd tiles per chunk), so a resumed fit is held so too
        held = _same_model(oom, kmeans["high"], ("cluster_centers_", "inertia_", "n_iter_"))
        if not held:
            diff = np.abs(oom.cluster_centers_ - kmeans["high"].cluster_centers_).max()
            fail(f"16b: the resumed streamed retry differs from the uninterrupted resident fit (centers by {diff}, "
                 f"inertia {oom.inertia_!r} vs {kmeans['high'].inertia_!r})")
        say(f"  16b kmeans high under oom:stage=solve:round={RECOVERY_OOM_AT}: the fault at the iteration-"
            f"{RECOVERY_OOM_AT} boundary after {resident_part} resident launches; the streamed retry "
            f"({oom._fit_metrics['admission']['chunk_rows']} admitted rows a chunk) restored that checkpoint and "
            f"streamed {streamed_part} (iterations {RECOVERY_OOM_AT + 1}-{RECOVERY_KMEANS['maxIter']} and the final "
            f"inertia); {timings['kmeans_high_oom_retry_s']:.2f} s; counters {recovery_counters(c_oom)}; held BIT "
            "FOR BIT to 16a's uninterrupted resident fit (13b's streamed = resident gate)")

        # ---- 16c: LogisticRegression's two loops ------------------------
        real_common, loops = LG._fit_common, []

        def spy_common(*a, **kw):
            out = real_common(*a, **kw)
            loops.append((out["n_iter_"], out["host_reads_"]))
            return out

        LG._fit_common = spy_common
        lr_data = {"features": X, "label": y_cls}
        try:
            with device_dataset_scope():
                for name, params in RECOVERY_LOGREG:
                    def make(params=params):
                        return LogisticRegression(**params)

                    loops.clear()
                    plain, _, _ = fit(f"logreg_{name}_unchecked_s", make, lr_data)
                    if name == "glm_qn":
                        refs["glm"] = plain
                    ckpt, c_ckpt, _ = fit(f"logreg_{name}_checkpointed_s", make, lr_data, every=RECOVERY_LOGREG_EVERY)
                    # the fault at the iteration-20 boundary, or the last
                    # boundary this fit reaches
                    at = min(RECOVERY_LOGREG_FAULT_AT,
                             (plain.n_iter_ - 1) // RECOVERY_LOGREG_EVERY * RECOVERY_LOGREG_EVERY or plain.n_iter_)
                    res, c_res, _ = fit(f"logreg_{name}_resumed_s", make, lr_data, every=RECOVERY_LOGREG_EVERY,
                                        plan=f"fail:stage=solve:round={at}")
                    attrs = ("coef_", "intercept_", "n_iter_", "objective_")
                    for tag, m in (("checkpointed", ckpt), ("resumed", res)):
                        if not _same_model(m, plain, attrs):
                            fail(f"16c {name}: the {tag} fit differs from the unchecked one: n_iter_ "
                                 f"{m.n_iter_}/{plain.n_iter_}, objective {m.objective_!r} vs {plain.objective_!r}, "
                                 f"coefficients by {np.abs(m.coef_ - plain.coef_).max()}")
                    n_saves = -(-plain.n_iter_ // RECOVERY_LOGREG_EVERY)
                    want_counters(f"logreg {name} checkpointed", c_ckpt, **{"checkpoint.saves": n_saves})
                    want_counters(f"logreg {name} resumed", c_res, **{"fit.retries": 1, "checkpoint.restores": 1,
                                                                      "checkpoint.saves": n_saves})
                    (n0, r0), (n1, r1) = loops[0], loops[1]
                    timings[f"logreg_{name}_reads_per_iter"] = r0 / n0
                    timings[f"logreg_{name}_reads_per_iter_checkpointed"] = r1 / n1
                    if r1 != r0 + n_saves:
                        fail(f"16c {name}: {r1} host reads with checkpoints against {r0} without and {n_saves} saves")
                    say(f"  16c logreg {name} {params}: unchecked {timings[f'logreg_{name}_unchecked_s']:.2f} s, "
                        f"checkpointed every {RECOVERY_LOGREG_EVERY} {timings[f'logreg_{name}_checkpointed_s']:.2f} "
                        f"s, resumed after the fault at the iteration-{at} boundary "
                        f"{timings[f'logreg_{name}_resumed_s']:.2f} s; the three equal bit for bit (n_iter_ "
                        f"{plain.n_iter_}, objective {plain.objective_:.9g}); resumed counters "
                        f"{recovery_counters(c_res)}; host reads per iteration {r0 / n0:.3f} unchecked, "
                        f"{r1 / n1:.3f} checkpointed ({r0} and {r1} over {n0} iterations)")
        finally:
            LG._fit_common = real_common
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 16d: PCA and OLS, retained statistics ----------------------
        passes, t_fault = [], {}
        real_cov, real_stats, real_stage = P.weighted_cov, LR._sufficient_stats, chaos.maybe_fail_stage

        def count(fn):
            def counted(*a, **kw):
                passes.append(1)
                return fn(*a, **kw)
            return counted

        def stamp(stage, index):
            try:
                real_stage(stage, index)
            except BaseException:
                t_fault["t"] = time.perf_counter()
                raise

        P.weighted_cov, LR._sufficient_stats, chaos.maybe_fail_stage = count(real_cov), count(real_stats), stamp
        lin_data = {"features": X, "label": linear_ref["y"]}
        try:
            for name, make, fit_data, attrs, pass_s in (
                    ("pca", lambda: PCA(k=PCA_K).setInputCol("features"), data,
                     ("components_", "explained_variance_", "mean_"), linear_timings["pca_stats_s"]),
                    ("ols", lambda: LinearRegression(), lin_data, ("coef_", "intercept_"),
                     linear_timings["linear_stats_s"])):
                with device_dataset_scope():
                    plain, _, _ = fit(f"{name}_unchecked_s", make, fit_data)
                    passes.clear()
                    res, c_res, _ = fit(f"{name}_resumed_s", make, fit_data, every=1, plan="fail:stage=solve:times=1")
                    t_end = time.perf_counter()
                retry_s = t_end - t_fault["t"]
                timings[f"{name}_retry_s"] = retry_s
                want_counters(f"{name} resumed", c_res, **{"fit.retries": 1, "checkpoint.stats_reuses": 1,
                                                           "checkpoint.saves": 1})
                if len(passes) != 1:
                    fail(f"16d {name}: {len(passes)} statistics passes in the faulted fit (one expected)")
                if not _same_model(res, plain, attrs):
                    fail(f"16d {name}: the resumed fit differs from the unchecked one")
                say(f"  16d {name}: unchecked {timings[f'{name}_unchecked_s']:.2f} s, resumed after "
                    f"`fail:stage=solve` {timings[f'{name}_resumed_s']:.2f} s, of which the retry {retry_s:.3f} s "
                    f"after the fault (phase 7a's statistics pass {pass_s:.3f} s) with one statistics pass in all; "
                    f"equal bit for bit; counters {recovery_counters(c_res)}")
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            P.weighted_cov, LR._sufficient_stats, chaos.maybe_fail_stage = real_cov, real_stats, real_stage

        # ---- 16e: the streamed GLM and OLS ------------------------------
        rows = slice(0, RECOVERY_STREAM_ROWS)
        config["hbm_budget_bytes"], config["stream_chunk_rows"] = RECOVERY_STREAM_BUDGET, 0
        for name, make, fit_data, attrs, every, at in (
                ("glm", lambda: LogisticRegression(**RECOVERY_STREAM_LOGREG),
                 {"features": X[rows], "label": y_cls[rows]}, ("coef_", "intercept_", "n_iter_", "objective_"),
                 RECOVERY_STREAM_EVERY, RECOVERY_STREAM_EVERY),
                ("ols", lambda: LinearRegression(), {"features": X[rows], "label": linear_ref["y"][rows]},
                 ("coef_", "intercept_"), 1, 0)):
            plain, c_plain, _ = fit(f"stream_{name}_s", make, fit_data)
            res, c_res, _ = fit(f"stream_{name}_resumed_s", make, fit_data, every=every,
                                plan=f"fail:stage=solve:round={at}")
            adm = res._fit_metrics["admission"]
            if plain._fit_metrics["admission"]["verdict"] != "stream" or adm["verdict"] != "stream":
                fail(f"16e {name}: not streamed under {RECOVERY_STREAM_BUDGET} bytes ({adm})")
            want = {"fit.retries": 1, "checkpoint.restores": 1} if name == "glm" else \
                {"fit.retries": 1, "checkpoint.stats_reuses": 1}
            want_counters(f"stream {name}", c_res, **want)
            if not _same_model(res, plain, attrs):
                fail(f"16e {name}: the resumed streamed fit differs from the uninterrupted one")
            # passes: the GLM's scaling pass, its first gradient and two an
            # iteration, and the retry's scaling again (the restored state
            # holds the gradient); OLS's one statistics pass, not repeated
            n_passes = c_res.get("ingest.stream_rows", 0) / RECOVERY_STREAM_ROWS
            want_passes = 3 + 2 * plain.n_iter_ if name == "glm" else 1
            if n_passes != want_passes:
                fail(f"16e {name}: {n_passes} streamed passes in the resumed fit, {want_passes} expected")
            say(f"  16e streamed {name} ({RECOVERY_STREAM_ROWS} x {N_COLS} under {RECOVERY_STREAM_BUDGET} bytes, "
                f"{adm['chunk_rows']} rows a chunk): uninterrupted {timings[f'stream_{name}_s']:.2f} s "
                f"({c_plain.get('ingest.stream_rows', 0) / RECOVERY_STREAM_ROWS:g} passes), resumed after the fault "
                f"at {at} {timings[f'stream_{name}_resumed_s']:.2f} s ({n_passes:g} passes); equal bit for bit"
                + (f" (n_iter_ {plain.n_iter_}, objective {plain.objective_:.9g})" if name == "glm" else "")
                + f"; counters {recovery_counters(c_res)}")
    finally:
        config.update(saved)
        chaos.clear_fault_plan()
        if not was_on:
            telemetry.disable()
    counts = {k_: n for k_, n in _kernels.launches.items() if n}
    say("  launches in phase 16: " + ", ".join(f"{k_}={v}" for k_, v in counts.items()))
    return counts, timings, refs


# Phase 17's shapes. 17a: bench_scheduler.py's contention lane at full width
# (4 tenants, 3 small jobs per bursting tenant, sched_max_preemptions 2); a
# big job is 16a's `fast` fit, the lane's maxIter 120 at a cadence of 3 cut to
# 6 at a cadence of 2; a small job the lane's KMeans(k, maxIter=10, seed=3)
# at k = 100 on the first 100,000 rows (a view), with random init as the big
# ones, for the script's time (the lane's k-means|| seeding made a small job
# 2.59 s on the card, 17a 17.4 s; phase 3 runs that seeding). 17b: 16c's GLM
# at a cadence of 10. 17c: 16a's `high` fit demoted after one preemption,
# streamed in 16b's chunks.
SCHED_TENANTS, SCHED_SMALL_JOBS, SCHED_BIG_EVERY = 4, 3, 2
SCHED_SMALL_ROWS = 100_000
SCHED_SMALL = {"k": 100, "maxIter": 10, "seed": 3, "initMode": "random"}
SCHED_GLM_EVERY = 10
SCHED_TIMEOUT = 600.0


def phase_scheduler(dev, X, y_cls, refs):
    """Phase 17: the multi-tenant fit scheduler on the protocol rows (the
    module comment's list), held to phase 16's unchecked fits (`refs`).
    Returns (the launches of the phase, timings)."""
    import gc
    import threading

    import torch

    from spark_rapids_ml_tpu_torch import (FitScheduler, KMeans, LogisticRegression, RandomForestClassifier, memory,
                                           ops_plane, telemetry)
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.errors import SchedulerSaturatedError
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops_plane import audit
    from spark_rapids_ml_tpu_torch.scheduler import global_ledger

    say(f"phase 17: the fit scheduler, {N_ROWS} x {N_COLS} float32")
    gc.collect()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    keys = ("hbm_budget_bytes", "checkpoint_every_iters", "sched_max_preemptions", "stream_chunk_rows")
    saved = {k_: config[k_] for k_ in keys}
    was_on = telemetry.enabled()
    telemetry.enable()
    reg = telemetry.registry()
    # phase 17 starts from an empty book: every earlier fit and served model
    # gave its claim back
    ledger = global_ledger()
    if ledger.reserved_bytes():
        fail("17: the ledger holds claims before the phase: " + ", ".join(
            f"{r.owner} (tenant {r.tenant}, {r.nbytes} bytes)" for r in ledger.reservations()))
    timings, tiles = {}, -(-N_ROWS // TILE_ROWS)
    big_data, small_data = {"features": X}, {"features": X[:SCHED_SMALL_ROWS]}
    _kernels.reset_launches()  # the scheduler run's launches: every job of the phase

    def need(est, data):
        ex = est._pre_process_data(data, for_fit=True, defer_validation=True)
        return memory.resident_estimate(est, ex).total()

    def budget_for(raw):
        """hbm_budget_bytes whose budget after the headroom is `raw`."""
        config["hbm_budget_bytes"] = int(raw / (1.0 - memory.headroom_fraction()))
        return int(config["hbm_budget_bytes"] * (1.0 - memory.headroom_fraction()))

    def moved(c0):
        return {k_: int(v - c0.get(k_, 0)) for k_, v in reg.snapshot()["counters"].items() if v != c0.get(k_, 0)}

    def launched(l0, l1=None):
        l1 = dict(_kernels.launches) if l1 is None else l1
        return {k_: n - l0.get(k_, 0) for k_, n in l1.items() if n != l0.get(k_, 0)}

    def spy_yield(job, into):
        """Record (solver, iteration, time) where `job` yields."""
        real = job.check_preempt

        def check(solver, iteration):
            try:
                real(solver, iteration)
            except BaseException:
                into.append((solver, iteration, time.time()))
                raise

        job.check_preempt = check

    def requested_at(tenant):
        recs = [d for d in audit.decisions(tenant=tenant, kind="preemption") if d["verdict"] == "requested"]
        return recs[0]["t"] if recs else None

    def same(a, b, attrs):
        return all(np.array_equal(np.asarray(getattr(a, n)), np.asarray(getattr(b, n))) for n in attrs)

    over, decisions = [0], [0]

    def conformance(reserved, budget):  # at EVERY admission decision
        decisions[0] += 1
        if budget is not None and reserved > budget:
            over[0] += 1

    ledger.admission_hooks.append(conformance)
    try:
        # ---- 17a: the contention lane -----------------------------------
        def mk_big():
            return KMeans(**RECOVERY_KMEANS)

        def mk_small():
            return KMeans(**SCHED_SMALL)

        config["checkpoint_every_iters"] = SCHED_BIG_EVERY
        config["sched_max_preemptions"] = 2
        # a small job's uninterrupted passes, and its model, alone
        l0 = dict(_kernels.launches)
        solo, timings["small_alone_s"] = _timed(lambda: mk_small().fit(small_data))
        l_small = launched(l0)
        need_b, need_s = need(mk_big(), big_data), need(mk_small(), small_data)
        # a big job fits alone, but not beside one small job: the burst
        # preempts the running big job, and the big jobs serialize
        budget = budget_for(need_b + 0.5 * need_s)
        yielded, jobs = [], []
        c0, l0, d0 = dict(reg.snapshot()["counters"]), dict(_kernels.launches), decisions[0]
        t0 = time.perf_counter()
        sched = FitScheduler()
        try:
            for t in range(SCHED_TENANTS):
                tenant = f"tenant{t}"
                if t % 2 == 0:
                    jobs.append((sched.submit(mk_big(), big_data, tenant=tenant, priority=0), N_ROWS))
                    if t == 0:
                        spy_yield(jobs[0][0], yielded)
                else:
                    # right after the first big job's admission: its
                    # preemption is requested during its 12 GB placement
                    jobs += [(sched.submit(mk_small(), small_data, tenant=tenant, priority=10), SCHED_SMALL_ROWS)
                             for _ in range(SCHED_SMALL_JOBS)]
            models = [j.result(timeout=SCHED_TIMEOUT) for j, _ in jobs]
            wall = time.perf_counter() - t0
            stats = sched.stats()
        finally:
            sched.shutdown(wait=True, timeout=SCHED_TIMEOUT)
        c_a, l_a = moved(c0), launched(l0)
        timings["contention_s"] = wall
        if over[0]:
            fail(f"17a: {over[0]} admission decisions over the {budget}-byte budget")
        n_pre, n_res = c_a.get("scheduler.jobs_preempted", 0), c_a.get("scheduler.jobs_resumed", 0)
        if not (n_pre >= 1 and n_res == n_pre and c_a.get("scheduler.jobs_completed", 0) == len(jobs)):
            fail(f"17a: {n_pre} preemptions, {n_res} resumes, "
                 f"{c_a.get('scheduler.jobs_completed', 0)}/{len(jobs)} jobs completed")
        if not yielded:
            fail("17a: the first big job never yielded at a boundary")
        big_ref, small_jobs = refs["kmeans"]["fast"], [(j, m) for (j, _), m in zip(jobs, models) if j.priority]
        for (job, _), m in zip(jobs, models):
            ref, attrs = ((big_ref, ("cluster_centers_", "inertia_", "n_iter_")) if not job.priority
                          else (solo, ("cluster_centers_", "inertia_", "n_iter_")))
            if not same(m, ref, attrs):
                fail(f"17a: job {job.job_id} ({job.tenant}) differs from its uninterrupted fit (centers by "
                     f"{np.abs(m.cluster_centers_ - ref.cluster_centers_).max()}, n_iter_ {m.n_iter_}/{ref.n_iter_})")
        want = {}
        for part, times in ((refs["kmeans_launches"]["fast"], 2), (l_small, SCHED_TENANTS // 2 * SCHED_SMALL_JOBS)):
            for k_, n in part.items():
                want[k_] = want.get(k_, 0) + times * n
        if l_a != want:
            fail(f"17a: launches {l_a}, while the uninterrupted passes of the {len(jobs)} jobs are {want}")
        solver, at, t_yield = yielded[0]
        margin = t_yield - requested_at("tenant0")
        timings["preemption_margin_s"] = margin
        rows = sum(n for _, n in jobs)
        byte_s = sum(j.admitted_bytes * j.run_s for j, _ in jobs)
        usage = ledger.tenant_usage()
        ledger_byte_s = sum(usage[f"tenant{t}"]["byte_seconds"] for t in range(SCHED_TENANTS))
        timings["utilization"] = byte_s / (budget * wall)
        timings["utilization_ledger"] = ledger_byte_s / (budget * wall)
        waits = {t: (s["queue_wait_p50_s"], s["queue_wait_p99_s"]) for t, s in stats["tenants"].items()}
        hi_waits = [j.queue_wait_s for j, _ in small_jobs]
        timings["queue_wait_by_tenant_s"] = waits
        timings["hi_priority_wait_p50_s"] = telemetry.quantile_of(hi_waits, 0.5)
        timings["hi_priority_wait_p99_s"] = telemetry.quantile_of(hi_waits, 0.99)
        say(f"  17a contention ({SCHED_TENANTS} tenants: 2 big KMeans(k={K}) jobs on {N_ROWS} rows at priority 0, "
            f"{SCHED_TENANTS // 2 * SCHED_SMALL_JOBS} small KMeans(k={SCHED_SMALL['k']}) jobs on "
            f"{SCHED_SMALL_ROWS} rows at priority 10; budget {budget} bytes = big {need_b} + half a small "
            f"{need_s}): wall {wall:.2f} s, {rows / wall:.4g} rows/s, utilization {timings['utilization']:.4f} "
            f"(ledger byte-seconds {timings['utilization_ledger']:.4f}); {n_pre} preemption(s), {n_res} "
            f"resume(s), {c_a.get('scheduler.jobs_demoted', 0)} demotion(s); the first big job yielded at "
            f"{solver} iteration {at}, {margin:.3f} s after the request; {decisions[0] - d0} admission "
            f"decisions, none over budget; every job equal to its uninterrupted fit bit for bit (the big ones to "
            f"16a's unchecked `fast` fit); launches {l_a} = 2 big + {SCHED_TENANTS // 2 * SCHED_SMALL_JOBS} "
            f"small uninterrupted fits (a small job alone {timings['small_alone_s']:.2f} s), no iteration twice")
        say("  17a queue wait p50/p99 by tenant (s): " + ", ".join(
            f"{t} {p50:.3f}/{p99:.3f}" for t, (p50, p99) in sorted(waits.items()))
            + f"; high-priority jobs {timings['hi_priority_wait_p50_s']:.3f}/{timings['hi_priority_wait_p99_s']:.3f}")
        del models, jobs, small_jobs, solo
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 17b: the GLM boundary --------------------------------------
        def mk_glm():
            return LogisticRegression(**RECOVERY_LOGREG[0][1])

        glm_big, glm_small = ({"features": X, "label": y_cls},
                              {"features": X[:SCHED_SMALL_ROWS], "label": y_cls[:SCHED_SMALL_ROWS]})
        config["checkpoint_every_iters"] = SCHED_GLM_EVERY
        budget = budget_for(need(mk_glm(), glm_big) + 0.5 * need(mk_glm(), glm_small))
        yielded, c0 = [], dict(reg.snapshot()["counters"])
        t0 = time.perf_counter()
        with FitScheduler() as sched:
            big = sched.submit(mk_glm(), glm_big, tenant="glm_batch", priority=0)
            spy_yield(big, yielded)
            hi = sched.submit(mk_glm(), glm_small, tenant="glm_interactive", priority=10)
            hi.result(timeout=SCHED_TIMEOUT)
            m_big = big.result(timeout=SCHED_TIMEOUT)
        timings["glm_s"] = time.perf_counter() - t0
        c_b = moved(c0)
        if not (big.preemptions == 1 and yielded and c_b.get("checkpoint.restores", 0) >= 1):
            fail(f"17b: {big.preemptions} preemptions of the GLM, yields {yielded}, counters {c_b}")
        if not same(m_big, refs["glm"], ("coef_", "intercept_", "n_iter_", "objective_")):
            fail(f"17b: the resumed GLM differs from 16c's unchecked fit (n_iter_ {m_big.n_iter_}/"
                 f"{refs['glm'].n_iter_}, coefficients by {np.abs(m_big.coef_ - refs['glm'].coef_).max()})")
        solver, at, t_yield = yielded[0]
        say(f"  17b GLM {RECOVERY_LOGREG[0][1]} at a cadence of {SCHED_GLM_EVERY} (budget {budget} bytes): "
            f"yielded at {solver} iteration {at}, {t_yield - requested_at('glm_batch'):.3f} s after the "
            f"request, to a priority-10 fit on {SCHED_SMALL_ROWS} rows; resumed equal to 16c's unchecked fit bit "
            f"for bit (n_iter_ {m_big.n_iter_}, objective {m_big.objective_:.9g}); {timings['glm_s']:.2f} s")
        del m_big, hi, big
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 17c: demotion ----------------------------------------------
        config.update(hbm_budget_bytes=None, checkpoint_every_iters=RECOVERY_KMEANS_EVERY, sched_max_preemptions=1,
                      stream_chunk_rows=RECOVERY_OOM_CHUNK_ROWS)
        est = KMeans(**RECOVERY_KMEANS, distance_precision="high")
        gate, at_save = threading.Event(), {}
        real_fit = est.fit

        def gated_fit(dataset, *a, **kw):
            if not gate.wait(SCHED_TIMEOUT):
                fail("17c: the job's fit was never released")
            return real_fit(dataset, *a, **kw)

        est.fit = gated_fit
        c0, l0 = dict(reg.snapshot()["counters"]), dict(_kernels.launches)
        t0 = time.perf_counter()
        with FitScheduler() as sched:
            job = sched.submit(est, big_data, tenant="demoted", priority=0)
            real_save = job.store.save

            def save(key, ckpt):  # the first checkpoint landed: ask the job to yield
                real_save(key, ckpt)
                if not at_save:
                    at_save.update(iteration=ckpt.iteration, launches=dict(_kernels.launches))
                    job.request_preempt("the phase asks the job to yield after its first checkpoint")

            job.store.save = save
            gate.set()
            m_dem = job.result(timeout=SCHED_TIMEOUT)
        timings["demotion_s"] = time.perf_counter() - t0
        c_c = moved(c0)
        adm = m_dem._fit_metrics["admission"]
        resident_part = launched(l0, at_save.get("launches", l0))
        streamed_part = launched(at_save.get("launches", l0))
        n_before = at_save.get("iteration", 0)
        n_after = RECOVERY_KMEANS["maxIter"] - n_before + 1  # the later iterations and the final inertia
        want_res = {f"{kern}/f32": n_before * tiles for kern in ("assign_argmin", "assign_accumulate")}
        want_str = {f"{kern}/f32": n_after * tiles for kern in ("assign_argmin", "assign_accumulate")}
        if not (c_c.get("scheduler.jobs_demoted") == 1 and c_c.get("scheduler.jobs_preempted") == 1
                and adm["verdict"] == "stream" and "sched_max_preemptions" in adm["reason"]):
            fail(f"17c: counters {c_c}, admission {adm}")
        if n_before != RECOVERY_KMEANS_EVERY or resident_part != want_res or streamed_part != want_str:
            fail(f"17c: yielded after iteration {n_before}; launches resident {resident_part} (want {want_res}), "
                 f"streamed {streamed_part} (want {want_str})")
        if not same(m_dem, refs["kmeans"]["high"], ("cluster_centers_", "inertia_", "n_iter_")):
            fail(f"17c: the demoted fit differs from 16a's unchecked `high` fit (centers by "
                 f"{np.abs(m_dem.cluster_centers_ - refs['kmeans']['high'].cluster_centers_).max()})")
        say(f"  17c demotion (sched_max_preemptions 1): 16a's `high` fit yielded after its iteration-{n_before} "
            f"checkpoint ({resident_part} resident launches), was demoted and resumed streamed in "
            f"{adm['chunk_rows']}-row chunks ({streamed_part}); reason {adm['reason']!r}; equal to 16a's "
            f"unchecked `high` fit bit for bit; {timings['demotion_s']:.2f} s; counters "
            f"{ {k_: v for k_, v in c_c.items() if k_.startswith(('scheduler.', 'checkpoint.restores'))} }")
        del m_dem, est, job
        gc.collect()
        torch.cuda.empty_cache()

        # ---- 17d: the typed refusal and the ops plane -------------------
        rf, rf_data = RandomForestClassifier(), {"features": X, "label": y_cls}
        resident = need(rf, rf_data)
        budget = budget_for(resident // 2)
        with FitScheduler() as sched:
            try:
                sched.submit(rf, rf_data, tenant="rf_hopeless", priority=5)
                fail("17d: a RandomForestClassifier over the budget was not refused")
            except SchedulerSaturatedError as e:
                refusal = e
        if not (refusal.largest_term == "placement.X" and refusal.tenant == "rf_hopeless"
                and refusal.estimate_bytes == resident and refusal.budget_bytes == budget):
            fail(f"17d: refusal {refusal!r} (largest term {refusal.largest_term})")
        tenants = ops_plane.report()["tenants"]
        named = [f"tenant{t}" for t in range(SCHED_TENANTS)] + ["glm_batch", "glm_interactive", "demoted"]
        short = [t for t in named if not tenants.get(t, {}).get("byte_seconds", 0) > 0]
        if short or "_pool" not in tenants:
            fail(f"17d: tenants without byte-seconds {short} (report tenants {sorted(tenants)})")
        trail = {(d["kind"], d["subsystem"], d["verdict"], d["tenant"]) for d in audit.decisions()}
        want_trail = {("admission", "scheduler", "admitted", "tenant0"), ("preemption", "scheduler", "requested", "tenant0"),
                      ("preemption", "scheduler", "preempted", "tenant0"), ("admission", "scheduler", "resumed", "tenant0"),
                      ("admission", "scheduler", "admitted", "tenant1"), ("admission", "scheduler", "admitted", "tenant3"),
                      ("preemption", "scheduler", "requested", "glm_batch"),
                      ("demotion", "scheduler", "stream", "demoted"), ("demotion", "fit", "stream", "demoted"),
                      ("admission", "scheduler", "refused", "rf_hopeless")}
        if want_trail - trail:
            fail(f"17d: the audit log lacks {sorted(want_trail - trail)}")
        say(f"  17d refused at submit: {refusal}; ops report tenants "
            + ", ".join(f"{t} {tenants[t]['byte_seconds']:.4g} B*s" for t in named)
            + f", _pool chips_busy {tenants['_pool']['chips_busy']:g}; every audit record with its job's tenant")
        if ledger.reserved_bytes():
            fail(f"17: {ledger.reserved_bytes()} bytes left in the ledger")
    finally:
        ledger.admission_hooks.remove(conformance)
        config.update(saved)
        if not was_on:
            telemetry.disable()
    # the schedulers' workers took their cuBLAS workspaces before any
    # placement, so no freed 12 GB placement stays reserved behind one
    # (phase 13c caps the allocator)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_reserved(dev) - reserved0
    say(f"  on the card after the jobs: {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated, "
        f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB reserved ({reserved0 / 1e9:.3f} GB before the phase)")
    if left > (1 << 30):
        fail(f"17: {left / 1e9:.3f} GB more reserved on the card than before the phase")
    counts = {k_: n for k_, n in _kernels.launches.items() if n}
    say("  launches in phase 17: " + ", ".join(f"{k_}={v}" for k_, v in counts.items()))
    return counts, timings


# ---------------------------------------------------------------- phase 18 --
#
# Multi-process fits: two ranks, each a fresh interpreter (this script with
# `--mp-worker`), share the card over a gloo process group and meet through
# a FileRendezvous; each rebuilds only its own rows of _protocol_rows, split
# on the generator's chunk boundaries (rank 0: rows [0, MP_SPLIT), rank 1:
# [MP_SPLIT, N_ROWS)), reads its share of phase 4's queries and its labels
# from files the parent writes, and fits under TpuContext with
# hbm_budget_bytes half the card.

MP_NRANKS = 2
MP_SPLIT = 9 * PROTOCOL_CHUNK  # 589,824 rows on rank 0, 410,176 on rank 1
MP_KMEANS = {"k": K, "maxIter": 3, "tol": 1e-20, "initMode": "random", "seed": 1}
MP_QUERIES = KNN_QUERIES // MP_NRANKS  # each rank's share of phase 4's queries
MP_TIMEOUT_S = 600.0
MP_KMEANS_RTOL = 1e-4  # the inertia against the plain one-process fit
MP_ASSIGN_AGREE = 0.999  # the share of sampled assignments equal to the plain one-process fit's
MP_ASSIGN_STEP = 16  # every 16th row's assignment compared
MP_KNN_RTOL = 1e-5
MP_MODEL_KEYS = ("init_high", "init_fast", "km_high_centers", "km_high_inertia", "km_high_iter",
                 "km_fast_centers", "km_fast_inertia", "km_fast_iter", "pca_components", "pca_variance",
                 "pca_mean", "ols_coef", "ols_intercept", "lr_coef", "lr_intercept", "lr_objective", "lr_iter",
                 # 18c-18g
                 "rf_feature", "rf_threshold", "rf_node_stats", "rf_classes", "db_core", "um_emb",
                 "sp_lr_coef", "sp_lr_intercept", "sp_lr_objective", "sp_ols_coef", "sp_ols_intercept",
                 # 18h
                 "sweep_avg", "sweep_std", "sweep_best_reg", "sweep_best_coef", "sweep_best_intercept")
MP_KERNELS = ("assign_argmin/f32", "assign_argmin/f32-fast", "assign_accumulate/f32",
              "assign_accumulate/f32-fast", "d2_block/f32")
# 18c-18g, the fits after the headline five in the same two ranks. 18c:
# phase 9b's forest row with 8 trees (4 a rank; seed 0, bootstrap on), its
# training accuracy on a fixed sample of rows against a floor set before the
# first run: 9b's 0.9197 (25 trees on every row, PR 20's last call) less
# 0.07, since each of these 8 trees sees one rank's rows only
MP_FOREST = dict(RF_CONFIGS[0][1], numTrees=8)
MP_FOREST_SAMPLE, MP_FOREST_SAMPLE_SEED, MP_FOREST_ACC_FLOOR = 100_000, 18, 0.85
# 18d, 18e, 18g: the first 60% of phase 12's and 14's rows on rank 0
MP_SHARE = 0.6
# 18e: phase 12b's UMAP at its first row count (20,000; cut from 100,000 for
# the script's time)
# 18f: phase 11's indexes over each rank's rows and phase 4's queries; IVFFlat
# and IVFPQ at phase 11's nprobe held to its one-process recall@64 less this
# margin (set before the first run); CAGRA over the first MP_CAGRA_ROWS rows
# of each rank (131,072 in all; cut from 1M for the script's time)
MP_ANN_RECALL_MARGIN = 0.02
MP_CAGRA_ROWS = 65_536
# the ranks' ANN query tile (the estimator's default 1024: an IVFPQ search
# tile of 1024 queries holds ~20 GB of ADC candidates at a rank's list
# lengths, and both ranks search every query on the one card)
MP_ANN_BATCH = 256
# 18g: against phase 14's one-process fits: 14a's objective (relative), 14b's
# OLS coefficients (normwise, 14b's bound); the kNN ids equal 14e's
MP_SPARSE_OBJ_RTOL, MP_SPARSE_OLS_RTOL = 1e-6, 1e-4
# the fits of each sub-phase, as the ranks time them
MP_SUBPHASES = {
    "18": ("kmeans_high", "kmeans_fast", "pca", "ols", "logreg", "knn"),
    "18c": ("forest",),
    "18d": ("dbscan",),
    "18e": ("umap", "umap_transform"),
    "18f": ("ivfflat_build", "ivfflat_search", "ivfflat_all", "ivfpq_build", "ivfpq_search", "cagra_build",
            "cagra_search"),
    "18g": ("sparse_data", "sparse_logreg", "sparse_ols", "sparse_knn_data", "sparse_knn"),
    "18h": ("sweep",),
}
# 18h: 10a's CrossValidator over each rank's first MP_SWEEP_ROWS[r] rows
# (150,000 in all, cut from 1M for the script's time); the parent's
# one-process sweep over the same rows in rank order, given the ranks' folds
# (each rank draws its own over its rows) as a fold column, is held to the
# same winner and every avgMetric within MP_SWEEP_METRIC_ATOL, set before the
# first run
MP_SWEEP_ROWS = (90_000, 60_000)
MP_SWEEP_METRIC_ATOL = 0.01
# 18i: a recovery epoch. KMeans `high` over each rank's rows, checkpointed
# every MP_RECOVER_EVERY iterations, one rank loss allowed; rank 0 writes
# MP_KILL_MARK once its iteration-2 checkpoint has landed and waits there to
# be SIGKILLed by the parent. A heartbeat of MP_RECOVER_HEARTBEAT_S: the
# survivor declares the rank dead 1.5 intervals after its last beat
MP_RECOVER_KMEANS = {"k": K, "maxIter": 6, "tol": 0.0, "initMode": "random", "seed": 1,
                     "distance_precision": "high"}
MP_RECOVER_EVERY, MP_RECOVER_KILL_AT, MP_RECOVER_HEARTBEAT_S = 2, 2, 2.0
MP_KILL_MARK = "kill_rank0.json"
# 18j: the fleet plane over the two ranks. Each rank runs an ops round on
# every top-level trace round (`fleet_ops_round_seconds` 0), saves its last
# cluster view and its ops snapshot (under MP_OPS_DIR) after 18h, and 18i
# runs with the fleet still on
MP_OPS_DIR = "ops"


def _mp_fleet_on(reg, tmp):
    """18j's set-up in one rank: the fleet plane loaded, an ops round due on
    every trace round, the ops snapshots under tmp/MP_OPS_DIR, and
    `diagnostics.trace_scope` and `fleet.ops_round` wrapped to count each
    top-level scope the multi-process context opens (a fit's or a sweep's: a
    sweep's inner fits adopt its trace and open none) and the
    `rendezvous.allgather_s` rounds and seconds of its trace and ops rounds
    (the histogram's change across the scope's entry), and the ops rounds'
    wall seconds (payload and merge included). Returns the counts, filled
    as the fits run."""
    import contextlib

    from spark_rapids_ml_tpu_torch import diagnostics
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.ops_plane import fleet

    config.update(fleet_ops_round_seconds=0, ops_snapshot_dir=str(tmp / MP_OPS_DIR))
    stats = {"scopes": 0, "rounds": 0, "rounds_s": 0.0, "ops_calls": 0, "ops_s": 0.0, "ops_wall_s": 0.0}
    real_scope, real_round = diagnostics.trace_scope, fleet.ops_round

    def allgather_s():
        h = reg.snapshot()["histograms"].get("rendezvous.allgather_s") or {}
        return h.get("count", 0.0), h.get("sum", 0.0)

    @contextlib.contextmanager
    def scope(label, ctx=None):
        top = diagnostics.current_trace() is None and getattr(ctx, "is_spmd", False)
        n0, s0 = allgather_s()
        with real_scope(label, ctx) as tags:
            if top:
                n1, s1 = allgather_s()
                stats["scopes"] += 1
                stats["rounds"] += int(n1 - n0)
                stats["rounds_s"] += s1 - s0
            yield tags

    def ops_round(rendezvous, **kw):
        s0, t0 = allgather_s()[1], time.perf_counter()
        out = real_round(rendezvous, **kw)
        stats["ops_calls"] += 1
        stats["ops_wall_s"] += time.perf_counter() - t0
        stats["ops_s"] += allgather_s()[1] - s0
        return out

    diagnostics.trace_scope, fleet.ops_round = scope, ops_round
    return stats


def _mp_fleet_save(rank, tmp, reg, stats):
    """18j's live view in one rank, after 18h and before 18i: its last
    cluster view to tmp/fleet_view_rank<r>.json and its ops snapshot
    (`ops_plane.write_snapshot`: ops_snapshot.json for rank 0,
    ops_snapshot_rank_<r>.json for the others). Returns the fleet counters
    with `stats`, for the parent's gates."""
    from spark_rapids_ml_tpu_torch import ops_plane
    from spark_rapids_ml_tpu_torch.ops_plane import fleet

    (tmp / f"fleet_view_rank{rank}.json").write_text(json.dumps(fleet.cluster_view(), default=str))
    path = ops_plane.write_snapshot()
    c = reg.snapshot()["counters"]
    return {"ops_rounds": c.get("fleet.ops_rounds", 0), "ops_rounds_failed": c.get("fleet.ops_rounds_failed", 0),
            "snapshot": os.path.basename(path) if path else None, **stats}


def _mp_bounds(rank):
    return (0, MP_SPLIT) if rank == 0 else (MP_SPLIT, N_ROWS)


def _mp_share(n, rank):
    """Rank `rank`'s rows of an n-row set split MP_SHARE / the rest."""
    cut = int(n * MP_SHARE)
    return (0, cut) if rank == 0 else (cut, n)


def mp_worker(rank, nranks, tmp):
    """One rank of phase 18: its rows, its fits under TpuContext, its
    results in `tmp` (rank<r>.npz, rank<r>.json). Rank 0 then opens a
    one-rank NCCL group through the same code and checks its all-gather on
    the card (18b)."""
    import torch

    from spark_rapids_ml_tpu_torch import PCA, KMeans, LinearRegression, LogisticRegression, NearestNeighbors, telemetry
    from spark_rapids_ml_tpu_torch.core import config, device_dataset_scope
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import kmeans as km_ops
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    tmp = Path(tmp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    config["hbm_budget_bytes"] = torch.cuda.get_device_properties(dev).total_memory // nranks
    telemetry.enable()
    info = {"rank": rank}
    t0 = time.perf_counter()
    lo, hi = _mp_bounds(rank)
    X = _protocol_rows(lo, hi)
    Q = np.array(np.load(tmp / "queries.npy", mmap_mode="r")[rank * MP_QUERIES:(rank + 1) * MP_QUERIES])
    y_lin = np.array(np.load(tmp / "y_lin.npy", mmap_mode="r")[lo:hi])
    y_cls = np.array(np.load(tmp / "y_cls.npy", mmap_mode="r")[lo:hi])
    info["data_s"] = time.perf_counter() - t0
    inits = []
    real_fit = km_ops.kmeans_fit

    def recording_fit(X_, w_, init_centers, **kw):
        inits.append(np.array(init_centers))
        return real_fit(X_, w_, init_centers, **kw)

    km_ops.kmeans_fit = recording_fit
    reg = telemetry.registry()
    fleet_stats = _mp_fleet_on(reg, tmp)
    rdv = FileRendezvous(rank, nranks, str(tmp / "rdv"), timeout_s=MP_TIMEOUT_S, heartbeat_interval_s=5.0)
    with TpuContext(rank, nranks, rdv) as ctx:
        group = ctx.group
        info["backend"] = ctx.backend
        fits = {}

        def timed(name, fn):
            mark = reg.mark()
            c0, n0 = group.collective_s, group.calls
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize(dev)
            hists = reg.delta(mark)["histograms"]
            fits[name] = {
                "s": time.perf_counter() - t1,
                "place_s": hists.get("device_wait.layout_s", {}).get("sum", 0.0),
                "collective_s": group.collective_s - c0,
                "collectives": group.calls - n0,
            }
            print(f"rank {rank}: {name} {fits[name]['s']:.2f} s", flush=True)  # to the rank's log
            return out

        data = {"features": X}
        _kernels.reset_launches()  # the counts of this rank's fits alone
        with device_dataset_scope():  # one placement for both KMeans fits and PCA
            km_high = timed("kmeans_high", lambda: KMeans(**MP_KMEANS, distance_precision="high").fit(data))
            km_fast = timed("kmeans_fast", lambda: KMeans(**MP_KMEANS).fit(data))
            pca = timed("pca", lambda: PCA(k=PCA_K).setInputCol("features").fit(data))
        ols = timed("ols", lambda: LinearRegression().fit({"features": X, "label": y_lin}))
        lr = timed("logreg", lambda: LogisticRegression(**LOGREG_ROW).fit({"features": X, "label": y_cls}))
        nn = NearestNeighbors(k=KNN_K).setInputCol("features").fit(data)
        _, _, knn = timed("knn", lambda: nn.kneighbors({"features": Q}))
        del nn
        km_ops.kmeans_fit = real_fit  # the init record ends with the KMeans fits (the IVF builds call it too)
        info["spmd_rounds"] = reg.snapshot()["counters"].get("fit.device_dataset_spmd_rounds", 0)
        sub_launches = {"18": dict(_kernels.launches)}
        more = _mp_worker_rest(rank, tmp, X, Q, y_cls, timed, sub_launches)
        more.update(_mp_sweep(rank, X, y_cls, timed, info))
        sub_launches["18h"] = dict(_kernels.launches)
        info["fleet"] = _mp_fleet_save(rank, tmp, reg, fleet_stats)
        info["launches"] = {k_: n for k_, n in _kernels.launches.items() if n}
        info["sub_launches"] = {
            name: {k_: n - prev.get(k_, 0) for k_, n in now.items() if n - prev.get(k_, 0)}
            for (name, now), prev in zip(sub_launches.items(), [{}] + list(sub_launches.values())[:-1])
        }
    rdv.close()
    info["fits"] = fits
    if rank == 0:
        # 18b: the same code opens a one-rank group on the card: NCCL
        rdv1 = FileRendezvous(0, 1, str(tmp / "nccl"), timeout_s=120.0, heartbeat_interval_s=5.0)
        with TpuContext(0, 1, rdv1, require_distributed=True) as one:
            v = torch.arange(1 << 20, dtype=torch.float32, device=dev)
            t1 = time.perf_counter()
            (g,) = one.group.allgather(v)
            (r_,) = one.group.allreduce_fixed(v)
            torch.cuda.synchronize(dev)
            info["nccl"] = {"backend": one.backend, "device": str(g.device),
                            "equal": bool(torch.equal(g, v) and torch.equal(r_, v)),
                            "s": time.perf_counter() - t1}
            # 18b': the group reformed to generation 1 with no dead rank: its
            # communicator aborted, a new one opened over the reformed plane
            t1 = time.perf_counter()
            one.adopt_reform(one.rendezvous.reform(dead_ranks=(), generation=1))
            (g,) = one.group.allgather(v)
            torch.cuda.synchronize(dev)
            info["nccl_reform"] = {"backend": one.backend, "device": str(g.device), "equal": bool(torch.equal(g, v)),
                                   "generation": one.recovery_generation, "nranks": one.nranks,
                                   "s": time.perf_counter() - t1, **(one.group.reform_s or {})}
        rdv1.close()
    np.savez(
        tmp / f"rank{rank}.npz",
        init_high=inits[0], init_fast=inits[1],
        km_high_centers=km_high.cluster_centers_, km_high_inertia=np.asarray(km_high.inertia_),
        km_high_iter=np.asarray(km_high.n_iter_),
        km_fast_centers=km_fast.cluster_centers_, km_fast_inertia=np.asarray(km_fast.inertia_),
        km_fast_iter=np.asarray(km_fast.n_iter_),
        pca_components=pca.components_, pca_variance=pca.explained_variance_, pca_mean=pca.mean_,
        ols_coef=ols.coef_, ols_intercept=np.asarray(ols.intercept_),
        lr_coef=lr.coef_, lr_intercept=np.asarray(lr.intercept_), lr_objective=np.asarray(lr.objective_),
        lr_iter=np.asarray(lr.n_iter_),
        knn_ids=np.stack(knn["indices"].to_numpy()), knn_dist=np.stack(knn["distances"].to_numpy()),
        knn_query_ids=knn["query_id"].to_numpy(), **more,
    )
    (tmp / f"rank{rank}.json").write_text(json.dumps(info))
    # 18i last: rank 0 dies in it, after everything above is on disk
    return _mp_recover(rank, nranks, tmp, X)


def _sweep_validator(**kw):
    """10a's CrossValidator (18h's sweep); `kw` sets more of its params."""
    from spark_rapids_ml_tpu_torch import CrossValidator, LogisticRegression, MulticlassClassificationEvaluator, ParamGridBuilder

    est = LogisticRegression(**CV_LOGREG)
    grid = ParamGridBuilder().addGrid(est.getParam("regParam"), list(CV_REGS)).build()
    return CrossValidator(estimator=est, estimatorParamMaps=grid, numFolds=CV_FOLDS, seed=CV_SEED,
                          evaluator=MulticlassClassificationEvaluator(metricName="accuracy"), **kw)


def _mp_sweep(rank, X, y_cls, timed, info):
    """18h in one rank: 10a's sweep over the rank's first MP_SWEEP_ROWS
    rows, each fold's held-out gather timed (`tuning._gather_validation`);
    its counters, layouts and gathers to `info["sweep"]`. Returns the
    arrays for rank<r>.npz."""
    import torch

    from spark_rapids_ml_tpu_torch import telemetry, tuning

    n = MP_SWEEP_ROWS[rank]
    gathers, real = [], tuning._gather_validation

    def timed_gather(feats, labels):
        t0 = time.perf_counter()
        out = real(feats, labels)
        torch.cuda.synchronize()
        gathers.append({"s": time.perf_counter() - t0, "rows": int(out[0].shape[0]),
                        "bytes": int(out[0].numel() * out[0].element_size())})
        return out

    reg = telemetry.registry()
    mark = reg.mark()
    tuning._gather_validation = timed_gather
    try:
        model = timed("sweep", lambda: _sweep_validator().fit({"features": X[:n], "label": y_cls[:n]}))
    finally:
        tuning._gather_validation = real
    d = reg.delta(mark)
    info["sweep"] = {
        "counters": {k_: d["counters"].get(k_, 0) for k_ in (
            "ingest.datasets", "fit.device_dataset_builds", "fit.device_dataset_reuses", "fit.solves_batched",
            "fit.solves_sequential", "sweep.fits_completed")},
        "layouts": d["histograms"].get("device_wait.layout_s", {}).get("count", 0), "gathers": gathers,
    }
    return {"sweep_avg": np.asarray(model.avgMetrics), "sweep_std": np.asarray(model.stdMetrics),
            "sweep_best_reg": np.asarray(float(model.bestModel.getOrDefault("regParam"))),
            "sweep_best_coef": model.bestModel.coef_, "sweep_best_intercept": np.asarray(model.bestModel.intercept_)}


def _mp_recover(rank, nranks, tmp, X):
    """18i in one rank: KMeans over its rows under a new TpuContext
    (FileRendezvous with a heartbeat of MP_RECOVER_HEARTBEAT_S), inside a
    device_dataset_scope, checkpointed every MP_RECOVER_EVERY iterations.
    Rank 0 writes MP_KILL_MARK (with its launches so far) once its
    iteration-MP_RECOVER_KILL_AT checkpoint has landed and waits to be
    killed; the survivor writes recover_rank<r>.json and .npz: its centers,
    the centers it resumed from, its membership, counters, launches and the
    recovery's seconds."""
    import torch

    from spark_rapids_ml_tpu_torch import KMeans, core, diagnostics, telemetry
    from spark_rapids_ml_tpu_torch import checkpoint as ckpt
    from spark_rapids_ml_tpu_torch.core import config, device_dataset_scope
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    config.update(checkpoint_every_iters=MP_RECOVER_EVERY, recovery_max_rank_losses=1)
    resumed, layouts, reforms = [], [], []
    real_save, real_load = ckpt.CheckpointStore.save, ckpt.CheckpointStore.load
    real_layout, real_reform = core._TpuCaller._layout, FileRendezvous.reform

    def save(store, key, c):
        real_save(store, key, c)
        if rank == 0 and c.solver == "kmeans" and c.iteration == MP_RECOVER_KILL_AT:
            torch.cuda.synchronize()
            mark = {"t": time.time(), "launches": {k_: n for k_, n in _kernels.launches.items() if n}}
            (tmp / (MP_KILL_MARK + ".tmp")).write_text(json.dumps(mark))
            os.replace(tmp / (MP_KILL_MARK + ".tmp"), tmp / MP_KILL_MARK)
            time.sleep(MP_TIMEOUT_S)  # the parent's SIGKILL ends this process here

    def load(store, key):
        c = real_load(store, key)
        if c is not None and c.solver == "kmeans":
            resumed.append((int(c.iteration), np.array(c.state["centers"])))
        return c

    def layout(self, *a, **kw):
        t0 = time.perf_counter()
        out = real_layout(self, *a, **kw)
        layouts.append(time.perf_counter() - t0)
        return out

    def reform(self, *a, **kw):
        t0 = time.time()
        out = real_reform(self, *a, **kw)
        reforms.append({"t0": t0, "s": time.time() - t0})
        return out

    ckpt.CheckpointStore.save, ckpt.CheckpointStore.load = save, load
    core._TpuCaller._layout, FileRendezvous.reform = layout, reform
    reg = telemetry.registry()
    mark = reg.mark()
    _kernels.reset_launches()
    rdv = FileRendezvous(rank, nranks, str(tmp / "rdv_i"), timeout_s=MP_TIMEOUT_S,
                         heartbeat_interval_s=MP_RECOVER_HEARTBEAT_S)
    t0 = time.perf_counter()
    with TpuContext(rank, nranks, rdv) as ctx, device_dataset_scope():
        km = KMeans(**MP_RECOVER_KMEANS).fit({"features": X})
        torch.cuda.synchronize()
        counters = reg.delta(mark)["counters"]
        res = {"rank": rank, "fit_s": time.perf_counter() - t0, "nranks": ctx.nranks, "rank_now": ctx.rank,
               "generation": ctx.recovery_generation, "live": ctx.live_ranks_hint(), "backend": ctx.backend,
               "group_reform_s": ctx.group.reform_s, "layouts_s": layouts, "reforms": reforms,
               "n_iter": int(km.n_iter_), "inertia": float(km.inertia_),
               "resumed_iteration": [it for it, _ in resumed],
               "counters": {k_: v for k_, v in counters.items()
                            if k_.startswith(("fit.", "recovery.", "rendezvous.reforms", "checkpoint."))},
               "launches": {k_: n for k_, n in _kernels.launches.items() if n},
               # 18j: how the fleet plane met the dead rank (printed, not gated)
               "fleet": {"ops_rounds": counters.get("fleet.ops_rounds", 0),
                         "ops_rounds_failed": counters.get("fleet.ops_rounds_failed", 0),
                         "trace_exchange_failed": sum(e["kind"] == "trace_exchange_failed"
                                                      for e in diagnostics.flight_recorder().events())}}
    rdv.close()
    np.savez(tmp / f"recover_rank{rank}.npz", centers=km.cluster_centers_,
             resumed=resumed[0][1] if resumed else np.zeros(0))
    (tmp / f"recover_rank{rank}.json").write_text(json.dumps(res))
    return 0


def _mp_worker_rest(rank, tmp, X, Q, y_cls, timed, sub_launches):
    """18c-18g in one rank, after the headline fits: the forest, DBSCAN,
    UMAP, the ANN indexes and the sparse fits and kNN, each timed by
    `timed`; the launch counters after each sub-phase go to `sub_launches`.
    Rank 0 writes the forest's bin edges to `tmp` (edges.npy). Returns the
    arrays for rank<r>.npz."""
    import torch

    from spark_rapids_ml_tpu_torch import (DBSCAN, UMAP, ApproximateNearestNeighbors, LinearRegression,
                                           LogisticRegression, NearestNeighbors, RandomForestClassifier)
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import trees as tree_ops

    out = {}

    def done(name):
        torch.cuda.empty_cache()
        sub_launches[name] = dict(_kernels.launches)

    # 18c: phase 9b's forest, 4 trees a rank, the edges recorded
    edges, real_bins = [], tree_ops.quantile_bins

    def recording_bins(*a, **kw):
        edges.append(real_bins(*a, **kw))
        return edges[-1]

    tree_ops.quantile_bins = recording_bins
    try:
        rf = timed("forest", lambda: RandomForestClassifier(**MP_FOREST).fit({"features": X, "label": y_cls}))
    finally:
        tree_ops.quantile_bins = real_bins
    if rank == 0:
        np.save(tmp / "edges.npy", edges[0])
    out.update(rf_feature=rf.feature, rf_threshold=rf.threshold, rf_node_stats=rf.node_stats, rf_classes=rf.classes_)
    del rf
    done("18c")
    # 18d: phase 12a's DBSCAN, rows split MP_SHARE / the rest
    xb, _ = make_blobs(DBSCAN_ROWS, DBSCAN_COLS, DBSCAN_CENTERS, 0)
    a, b = _mp_share(DBSCAN_ROWS, rank)
    db = DBSCAN(eps=DBSCAN_EPS, min_samples=DBSCAN_MIN_SAMPLES, max_mbytes_per_batch=DBSCAN_MBYTES) \
        .setFeaturesCol("features").fit({"features": xb[a:b]})
    out["db_labels"] = timed("dbscan", lambda: db.transform({"features": xb[a:b]})["prediction"].to_numpy())
    out["db_core"] = db.core_sample_indices_
    done("18d")
    # 18e: phase 12b's UMAP at MP_UMAP_ROWS rows, rows split MP_SHARE / the rest
    xu, _ = make_blobs(MP_UMAP_ROWS, UMAP_COLS, UMAP_CENTERS, 0)
    a, b = _mp_share(MP_UMAP_ROWS, rank)
    um = timed("umap", lambda: UMAP(n_neighbors=UMAP_K, n_epochs=UMAP_EPOCHS, random_state=UMAP_SEED)
               .setFeaturesCol("features").fit({"features": xu[a:b]}))
    out["um_emb"] = um.embedding_
    out["um_transform"] = timed(
        "umap_transform", lambda: np.stack(um.transform({"features": xu[a:b]})["embedding"].to_list()))
    del um
    done("18e")
    # 18f: phase 11's indexes over this rank's rows, phase 4's queries; a
    # query tile of MP_ANN_BATCH rows, as two ranks' searches of all 4096
    # queries share the card
    ann = {algo: dict(ap, batch_queries=MP_ANN_BATCH) for algo, ap in ANN_CONFIGS}
    flat = timed("ivfflat_build", lambda: ApproximateNearestNeighbors(
        k=KNN_K, algorithm="ivfflat", algoParams=ann["ivfflat"]).setInputCol("features").fit({"features": X}))
    _, _, got = timed("ivfflat_search", lambda: flat.kneighbors({"features": Q}))
    out["ivfflat_ids"] = np.stack(got["indices"].to_numpy())
    flat._solver_params["n_probes"] = ann["ivfflat"]["nlist"]  # every list: each rank's search is exact
    _, _, got = timed("ivfflat_all", lambda: flat.kneighbors({"features": Q}))
    out["ivfflat_all_ids"] = np.stack(got["indices"].to_numpy())
    out["ivfflat_all_dist"] = np.stack(got["distances"].to_numpy())
    del flat
    torch.cuda.empty_cache()
    pq = timed("ivfpq_build", lambda: ApproximateNearestNeighbors(
        k=KNN_K, algorithm="ivfpq", algoParams=ann["ivfpq"]).setInputCol("features").fit({"features": X}))
    _, _, got = timed("ivfpq_search", lambda: pq.kneighbors({"features": Q}))
    out["ivfpq_ids"] = np.stack(got["indices"].to_numpy())
    del pq
    torch.cuda.empty_cache()
    cg = timed("cagra_build", lambda: ApproximateNearestNeighbors(
        k=KNN_K, algorithm="cagra", algoParams=ann["cagra"]).setInputCol("features")
        .fit({"features": X[:MP_CAGRA_ROWS]}))
    _, _, got = timed("cagra_search", lambda: cg.kneighbors({"features": Q}))
    out["cagra_ids"] = np.stack(got["indices"].to_numpy())
    del cg, got
    done("18f")
    # 18g: phase 14's sparse rows, split MP_SHARE / the rest; the generator
    # draws row lengths for every row first, so each rank builds all of them
    # (~1.3 s) and fits its own
    x, y, _ = timed("sparse_data", sparse_problem)
    y_lin, _ = sparse_linear_labels(x)
    a, b = _mp_share(SPARSE_ROWS, rank)
    xs, ys, ys_lin = x[a:b], y[a:b], y_lin[a:b]
    del x, y, y_lin
    lr = timed("sparse_logreg", lambda: LogisticRegression(**SPARSE_LOGREG).fit({"features": xs, "label": ys}))
    ols = timed("sparse_ols", lambda: LinearRegression(regParam=0.0).fit({"features": xs, "label": ys_lin}))
    out.update(sp_lr_coef=lr.coef_, sp_lr_intercept=np.asarray(lr.intercept_), sp_lr_objective=np.asarray(lr.objective_),
               sp_lr_iter=np.asarray(lr.n_iter_), sp_ols_coef=ols.coef_, sp_ols_intercept=np.asarray(ols.intercept_))
    del xs, ys, ys_lin, lr, ols
    items, queries = timed("sparse_knn_data", sparse_knn_problem)
    a, b = _mp_share(SPARSE_KNN_ROWS, rank)
    q_rows = slice(rank * SPARSE_KNN_QUERIES // MP_NRANKS, (rank + 1) * SPARSE_KNN_QUERIES // MP_NRANKS)
    snn = NearestNeighbors(k=SPARSE_KNN_K).setInputCol("features").fit({"features": items[a:b]})
    _, _, got = timed("sparse_knn", lambda: snn.kneighbors({"features": queries[q_rows]}))
    out.update(sp_knn_ids=np.stack(got["indices"].to_numpy()), sp_knn_dist=np.stack(got["distances"].to_numpy()))
    done("18g")
    return out


def _mp_launch(tmp):
    """Start the ranks as fresh interpreters and wait for them, each within
    MP_TIMEOUT_S; SIGKILL rank 0 once it has written 18i's kill mark (the
    wall-clock time of the kill is returned); every process is stopped
    before this returns. Rank 0's exit by that signal is the only non-zero
    exit accepted."""
    import signal

    procs, logs, killed_at = [], [], None
    try:
        for r in range(MP_NRANKS):
            log = open(tmp / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mp-worker", str(r), str(MP_NRANKS), str(tmp)],
                stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
            ))
        deadline = time.monotonic() + MP_TIMEOUT_S
        while time.monotonic() < deadline and any(p.poll() is None for p in procs):
            if killed_at is None and procs[0].poll() is None and (tmp / MP_KILL_MARK).exists():
                os.kill(procs[0].pid, signal.SIGKILL)
                killed_at = time.time()
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    rcs = [p.returncode for p in procs]
    expected = [-signal.SIGKILL if killed_at is not None else 0] + [0] * (MP_NRANKS - 1)
    if rcs != expected:
        for r in range(MP_NRANKS):
            say(f"  rank {r} (exit {rcs[r]}), last lines:\n" + "\n".join(
                (tmp / f"rank{r}.log").read_text().splitlines()[-25:]))
        fail(f"18: the ranks exited {rcs}, not {expected} (rank 0 killed in 18i: {killed_at is not None})")
    if killed_at is None:
        fail("18i: rank 0 never reached its iteration-2 checkpoint's kill mark")
    return killed_at


def phase_multiprocess(dev, X, linear_ref, logreg_ref, exact_ids, exact_dist, ann_ref, du_ref, sparse_ref):
    """Phase 18: multi-process fits at full width, two ranks sharing the
    card over gloo (see the constants above); the gates are the ranks'
    models equal bit for bit, KMeans held to one process (below), PCA, OLS
    and LogisticRegression held to phases 7a and 8a by phase 13b's bounds,
    the kNN ids equal to phase 4's and the distances within MP_KNN_RTOL,
    B1/B2/B3 launched on both ranks, and 18b's one-rank NCCL all-gather on
    the card. Then 18c-18g in the same ranks (`_mp_checks_rest`), against
    phase 11's recalls (`ann_ref`), phase 12's references (`du_ref`) and
    phase 14's (`sparse_ref`). Returns (launches summed over the ranks,
    timings).

    KMeans is held twice, from rank 0's init centers: bit for bit to a
    one-process Lloyd loop whose step sums the same two row blocks in rank
    order (what the collective computes), and to the plain one-process fit
    (one sum over all rows) by its inertia within MP_KMEANS_RTOL and at
    least MP_ASSIGN_AGREE of every MP_ASSIGN_STEP-th row's assignment equal:
    in float32 the two orders of summation move a center by an ulp, and a
    row near a tie between two centers can change sides by the third
    iteration."""
    import shutil
    import tempfile

    import torch

    from spark_rapids_ml_tpu_torch.ops.distance import tile_assign_accumulate
    from spark_rapids_ml_tpu_torch.ops.kmeans import _finish_centers, kmeans_fit, kmeans_predict, lloyd_loop
    from spark_rapids_ml_tpu_torch.ops_plane import fleet
    from spark_rapids_ml_tpu_torch.parallel import place_rows

    say(f"phase 18: multi-process fits, {MP_NRANKS} ranks sharing {torch.cuda.get_device_name(dev)} over gloo, "
        f"rows [0, {MP_SPLIT}) and [{MP_SPLIT}, {N_ROWS}) of the {N_ROWS} x {N_COLS} float32 rows; host memory "
        "{:.1f} of {:.1f} GB available".format(*reversed(_host_memory_gb())))
    LOG_DIR.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="mp_", dir=str(LOG_DIR)))
    timings = {}
    try:
        np.save(tmp / "y_lin.npy", linear_ref["y"])
        np.save(tmp / "y_cls.npy", logreg_ref["y"])
        np.save(tmp / "queries.npy", X[:KNN_QUERIES])  # phase 4's queries, split between the ranks
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # the earlier phases' cached blocks are released to the card
        t0 = time.perf_counter()
        killed_at = _mp_launch(tmp)
        timings["ranks_s"] = time.perf_counter() - t0
        got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(MP_NRANKS)]
        info = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(MP_NRANKS)]
        edges = np.load(tmp / "edges.npy")  # 18c's bin edges, as rank 0 derived them
        # 18i: rank 0's mark, the survivor's results
        kill_mark = json.loads((tmp / MP_KILL_MARK).read_text())
        survivor = json.loads((tmp / "recover_rank1.json").read_text())
        survivor.update({k_: v for k_, v in np.load(tmp / "recover_rank1.npz").items()})
        # 18j: the ranks' live views, and the offline merge of their snapshots
        views = [json.loads((tmp / f"fleet_view_rank{r}.json").read_text()) for r in range(MP_NRANKS)]
        snapshots = fleet.read_rank_snapshots(str(tmp / MP_OPS_DIR), nranks=MP_NRANKS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in range(MP_NRANKS):
        timings[f"rank{r}"] = {"data_s": info[r]["data_s"]}
        say(f"  rank {r} ({info[r]['backend']}): data {info[r]['data_s']:.2f} s")
        for sub, names in MP_SUBPHASES.items():
            f = {k_: info[r]["fits"][k_] for k_ in names}
            place = sum(v["place_s"] for v in f.values())
            coll = sum(v["collective_s"] for v in f.values())
            total = sum(v["s"] for v in f.values())
            timings[f"rank{r}"][sub] = {"fits_s": total, "placement_s": place, "collective_s": coll,
                                        "solve_s": total - place - coll,
                                        "collectives": sum(v["collectives"] for v in f.values()),
                                        "launches": info[r]["sub_launches"][sub]}
            say(f"    {sub}: fits {total:.2f} s = placement {place:.2f} + collectives {coll:.2f} "
                f"({timings[f'rank{r}'][sub]['collectives']} all-gathers) + solve {total - place - coll:.2f}; "
                + ", ".join(f"{k_} {v['s']:.2f}" for k_, v in f.items()) + "; launches "
                + (", ".join(f"{k_}={n}" for k_, n in info[r]["sub_launches"][sub].items()) or "none"))
        if info[r]["backend"] != "gloo":
            fail(f"18: rank {r} ran {info[r]['backend']}, not gloo (the ranks share the card)")
        for key in MP_MODEL_KEYS:
            if not np.array_equal(got[r][key], got[0][key]):
                fail(f"18: rank {r}'s {key} differs from rank 0's")
        for name in MP_KERNELS:
            if not info[r]["launches"].get(name):
                fail(f"18: rank {r} never launched {name}")
        if not info[r]["spmd_rounds"]:
            fail(f"18: rank {r} ran no placement-cache agreement round")
    g = got[0]
    say(f"  every rank's KMeans, PCA, OLS and LogisticRegression model equals rank 0's bit for bit; "
        f"placement-cache agreement rounds {info[0]['spmd_rounds']}")
    # KMeans against one process from the same init centers
    Xd, wd = place_rows(X, device=dev)
    sample = Xd[::MP_ASSIGN_STEP].contiguous()
    blocks = [_mp_bounds(r) for r in range(MP_NRANKS)]

    def ranked_step(c, fast):
        acc = None
        for a, b in blocks:
            part = tile_assign_accumulate(Xd[a:b], wd[a:b], c, TILE_ROWS, fast)
            acc = part if acc is None else tuple(x + y for x, y in zip(acc, part))
        return _finish_centers(*acc, c)

    for mode in ("high", "fast"):
        init = g[f"init_{mode}"]
        fit_args = dict(max_iter=MP_KMEANS["maxIter"], tol=MP_KMEANS["tol"])
        ranked = lloyd_loop(ranked_step, torch.from_numpy(init).to(dev), fast=mode == "fast", init_centers=init,
                            **fit_args)
        if not (np.array_equal(g[f"km_{mode}_centers"], ranked["cluster_centers_"].cpu().numpy())
                and float(g[f"km_{mode}_inertia"]) == float(ranked["inertia_"])
                and int(g[f"km_{mode}_iter"]) == int(ranked["n_iter_"])):
            fail(f"18 kmeans {mode}: the two-rank fit differs from one process summing the same blocks in rank order")
        plain = kmeans_fit(Xd, wd, init, batch_rows=TILE_ROWS, precision_mode=mode, **fit_args)
        c_ref = plain["cluster_centers_"]
        c_err = float(np.abs(g[f"km_{mode}_centers"] - c_ref.cpu().numpy()).max() / c_ref.abs().max().item())
        i_err = abs(float(g[f"km_{mode}_inertia"]) - float(plain["inertia_"])) / float(plain["inertia_"])
        a_spmd = kmeans_predict(sample, torch.from_numpy(g[f"km_{mode}_centers"]).to(dev))
        same = int((a_spmd == kmeans_predict(sample, c_ref)).sum())
        if int(g[f"km_{mode}_iter"]) != int(plain["n_iter_"]) or i_err > MP_KMEANS_RTOL \
                or same < MP_ASSIGN_AGREE * sample.shape[0]:
            fail(f"18 kmeans {mode}: n_iter_ {int(g[f'km_{mode}_iter'])}/{int(plain['n_iter_'])}, inertia within "
                 f"{i_err} (rtol {MP_KMEANS_RTOL}), {same}/{sample.shape[0]} equal assignments (at least "
                 f"{MP_ASSIGN_AGREE}) against the plain one-process fit")
        timings[f"kmeans_{mode}_assignments_equal"] = same / sample.shape[0]
        say(f"  18 kmeans {mode}: equal bit for bit to one process summing the rank blocks in rank order; against "
            f"the plain one-process fit from rank 0's init: inertia within {i_err:.3g} (rtol {MP_KMEANS_RTOL}), "
            f"{same}/{sample.shape[0]} sampled assignments equal, centers within {c_err:.3g} of the largest "
            "coordinate")
    del wd, sample
    rest = _mp_checks_rest(dev, X, Xd, got, edges, logreg_ref["y"], exact_ids, exact_dist, ann_ref, du_ref,
                           sparse_ref)
    del Xd
    torch.cuda.empty_cache()
    # PCA, OLS and LogisticRegression against phases 7a and 8a (phase 13b's bounds)
    pca_res, ols_res, spectrum = linear_ref["pca"], linear_ref["ols"], linear_ref["spectrum"]
    pert = 2 * F32_EIGH_REL * float(pca_res.explained_variance_[0])
    ev_err = float(np.abs(g["pca_variance"] - pca_res.explained_variance_).max())
    if ev_err > pert:
        fail(f"18 pca: explained variance within {ev_err} of phase 7a's (Weyl bound {pert})")
    cosines = []
    for i in range(PCA_K):
        gap = min(abs(spectrum[i] - spectrum[j]) for j in range(PCA_K + 1) if j != i) - 2 * pert
        cos = abs(float(g["pca_components"][i].astype(np.float64) @ pca_res.components_[i]))
        cosines.append(cos)
        if gap > 0 and pert / gap < 1 and cos < np.sqrt(1 - (pert / gap) ** 2):
            fail(f"18 pca: component {i}: |cos| {cos} below the Davis-Kahan bound {np.sqrt(1 - (pert / gap) ** 2)}")
    kappa = float(spectrum[0] / spectrum[-1])
    rel = 2 * kappa * F32_SOLVE_REL / (1 - 2 * kappa * F32_SOLVE_REL)
    c_err = float(np.linalg.norm(g["ols_coef"] - ols_res.coef_) / np.linalg.norm(ols_res.coef_))
    if c_err > rel:
        fail(f"18 ols: coefficients {c_err} relative from phase 7a's (normwise bound {rel})")
    base = logreg_ref["baseline"]
    f_err = abs(float(g["lr_objective"]) - base.objective_) / abs(base.objective_)
    lc_err = float(np.linalg.norm(g["lr_coef"] - base.coef_) / np.linalg.norm(base.coef_))
    if f_err > 1e-5 or lc_err > 1e-3:
        fail(f"18 logreg: objective within {f_err} (tol 1e-5), coefficients within {lc_err} (tol 1e-3) of phase 8a's")
    say(f"  18 pca: explained variance within {ev_err:.3g} (bound {pert:.3g}), |cos| "
        f"{[round(c, 9) for c in cosines]}; ols: coefficients within {c_err:.3g} (bound {rel:.3g}); logreg "
        f"{LOGREG_ROW}: n_iter_ {int(g['lr_iter'])} (phase 8a {base.n_iter_}), objective within {f_err:.3g}, "
        f"coefficients within {lc_err:.3g}")
    # kNN: each rank's queries are its share of phase 4's, in rank order
    worst = 0.0
    for r in range(MP_NRANKS):
        rows = slice(r * MP_QUERIES, (r + 1) * MP_QUERIES)
        if not np.array_equal(got[r]["knn_query_ids"], np.arange(rows.start, rows.stop)):
            fail(f"18 knn: rank {r}'s query ids are not rows {rows.start}..{rows.stop - 1}")
        if not np.array_equal(got[r]["knn_ids"], exact_ids[rows]):
            bad = int((got[r]["knn_ids"] != exact_ids[rows]).any(axis=1).sum())
            fail(f"18 knn: rank {r}: {bad} query rows' ids differ from phase 4's")
        d_ref = np.asarray(exact_dist[rows], dtype=np.float64)
        err = float((np.abs(got[r]["knn_dist"] - d_ref) / np.maximum(np.abs(d_ref), 1e-30))[:, 1:].max())
        worst = max(worst, err)
    if worst > MP_KNN_RTOL:
        fail(f"18 knn: distances within {worst} of phase 4's (rtol {MP_KNN_RTOL})")
    say(f"  18 knn: {KNN_QUERIES} queries ({MP_QUERIES} a rank), k = {KNN_K}: ids equal to phase 4's, distances "
        f"within {worst:.3g} (self-distances aside)")
    nccl = info[0].get("nccl") or {}
    if nccl.get("backend") != "nccl" or not nccl.get("equal") or not nccl.get("device", "").startswith("cuda"):
        fail(f"18b: the one-rank group's all-gather: {nccl}")
    timings["nccl_allgather_s"] = nccl["s"]
    say(f"  18b: a one-rank NCCL group's all-gather and fixed-order sum of 4 MB on {nccl['device']} equal the "
        f"input ({nccl['s']:.3f} s)")
    nccl = info[0].get("nccl_reform") or {}
    if (nccl.get("backend") != "nccl" or not nccl.get("equal") or nccl.get("generation") != 1
            or nccl.get("nranks") != 1):
        fail(f"18b': the reformed one-rank NCCL group: {nccl}")
    timings["nccl_reform"] = nccl
    say(f"  18b': the one-rank NCCL group reformed to generation 1 with no dead rank ({nccl['s']:.3f} s: the "
        f"communicator aborted in {nccl.get('teardown_s', float('nan')):.3f} s, a new group opened in "
        f"{nccl.get('open_s', float('nan')):.3f} s); its all-gather of 4 MB on {nccl['device']} equals the input")
    timings["18h"] = _mp_check_sweep(dev, X, got, info, logreg_ref["y"])
    timings["18i"] = _mp_check_recover(dev, X, kill_mark, killed_at, survivor)
    timings["18j"] = _mp_check_fleet(info, views, snapshots, survivor)
    counts = {}
    for launches in [info[r]["launches"] for r in range(MP_NRANKS)] + [kill_mark["launches"], survivor["launches"]]:
        for k_, n in launches.items():
            counts[k_] = counts.get(k_, 0) + n
    say("  launches in phase 18 (both ranks, 18i included): " + ", ".join(f"{k_}={v}" for k_, v in counts.items()))
    timings.update(rest)
    return counts, timings


MD_CHIPS = 2
MD_KMEANS = {"k": K, "maxIter": 3, "tol": 1e-20, "initMode": "random", "seed": 1}
MD_LOGREG = dict(LOGREG_ROW, maxIter=20)  # 8a's row, maxIter cut from 200
MD_TRANSFORM_ROWS = 200_000  # the split transform held to one chip's on these rows (cut from 1M)
COADMIT_ROWS = 262_144  # 17e: the first protocol rows (the lane's own 40,000 x 32, widened and deepened)
# the lane's job, its default k-means|| seeding replaced by the random init:
# at k = 8 over 262,144 x 3000 rows the port's k-means|| seeding takes ~48 s
# on the host (0.6 s of it on the card), the Lloyd loop 0.15 s (PERF.md)
COADMIT_KMEANS = {"k": 8, "maxIter": 12, "tol": 0.0, "seed": 7, "initMode": "random"}
COADMIT_RATIO = 1.5


def _md_pool():
    """Phase 19's pool: the visible cards when there are two or more, else
    two chips on card 0 (as phase 18's ranks share it)."""
    import torch

    n = torch.cuda.device_count()
    if n >= MD_CHIPS:
        return [f"cuda:{i}" for i in range(MD_CHIPS)], f"{MD_CHIPS} cards"
    return ["cuda:0"] * MD_CHIPS, f"{MD_CHIPS} chips on one card (cuda:0 twice)"


def phase_multidevice(dev, X, linear_ref, logreg_ref, exact_ids):
    """Phase 19: one process driving two chips (core.py's fan-out, one thread
    a chip over the in-process group) at num_workers=2 over the protocol
    rows, blocks [0, 500,000) and [500,000, 1M), inside one
    device_dataset_scope: KMeans high and fast (B1, B2), the split transform
    (B1), exact kNN of phase 4's queries (B3), PCA and LogisticRegression
    (8a's row, maxIter 20). Gates: every chip's model equal to rank 0's; the
    KMeans centers equal bit for bit to one process summing the two blocks in
    chip order from the same init; the split transform equal to one chip's;
    the kNN ids equal to phase 4's; PCA within phase 18's bounds of 7a's,
    the GLM within 1e-5 (objective) and 1e-3 (coefficients) of the same fit
    on one chip; the launches as the tiles say. Returns (launches, timings)."""
    import torch

    from spark_rapids_ml_tpu_torch import PCA, KMeans, LogisticRegression, NearestNeighbors, parallel, telemetry
    from spark_rapids_ml_tpu_torch.core import config, device_dataset_scope
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.ops import kmeans as km_ops
    from spark_rapids_ml_tpu_torch.ops.distance import tile_assign_accumulate
    from spark_rapids_ml_tpu_torch.ops.kmeans import _finish_centers, lloyd_loop
    from spark_rapids_ml_tpu_torch.ops_plane import fleet

    pool, what = _md_pool()
    say(f"phase 19: one process driving {what}, num_workers={MD_CHIPS}, over the {N_ROWS} x {N_COLS} float32 rows")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    was_on = telemetry.enabled()
    telemetry.enable()
    # the fleet plane on, an ops round due on every trace round: a fanned
    # fit's chips are no ranks of it, so none may run or leave a stamp
    fleet.reset()
    saved_interval = config["fleet_ops_round_seconds"]
    config["fleet_ops_round_seconds"] = 0
    counters0 = telemetry.registry().snapshot()["counters"]
    inits, timings, counts = [], {"pool": what}, {}
    real_fit = km_ops.kmeans_fit

    def recording_fit(X_, w_, init_centers, **kw):
        inits.append(np.array(init_centers))
        return real_fit(X_, w_, init_centers, **kw)

    def fanned(name, fn):
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        timings[name] = {"s": time.perf_counter() - t0}
        counts[name] = {k_: n for k_, n in _kernels.launches.items() if n}
        md = getattr(out, "_fit_metrics", {}).get("multidevice")
        if md is not None:
            if not md["models_equal"]:
                fail(f"19 {name}: a chip's model differs from rank 0's")
            timings[name]["chips"] = [
                {k_: st[k_] for k_ in ("chip_id", "device", "wall_s", "placement_s", "collective_s",
                                        "collective_calls")} for st in md["per_chip"]]
            for st in timings[name]["chips"]:
                st["solve_s"] = st["wall_s"] - st["placement_s"] - st["collective_s"]
        say(f"  19 {name}: {timings[name]['s']:.2f} s; " + "; ".join(
            f"chip {st['chip_id']} ({st['device']}): placement {st['placement_s']:.2f} s, collectives "
            f"{st['collective_s']:.2f} s ({st['collective_calls']}), solve {st['solve_s']:.2f} s"
            for st in timings[name].get("chips", [])) + "; launches " + (
            ", ".join(f"{k_}={n}" for k_, n in counts[name].items()) or "none"))
        return out

    data = {"features": X}
    parallel.set_devices(pool)
    km_ops.kmeans_fit = recording_fit
    try:
        with device_dataset_scope():  # one placement a chip for both KMeans fits and PCA
            km_high = fanned("kmeans_high", lambda: KMeans(**MD_KMEANS, distance_precision="high",
                                                           num_workers=MD_CHIPS).fit(data))
            km_fast = fanned("kmeans_fast", lambda: KMeans(**MD_KMEANS, num_workers=MD_CHIPS).fit(data))
            km_ops.kmeans_fit = real_fit
            pca = fanned("pca", lambda: PCA(k=PCA_K, num_workers=MD_CHIPS).setInputCol("features").fit(data))
        lr = fanned("logreg", lambda: LogisticRegression(**MD_LOGREG, num_workers=MD_CHIPS).fit(
            {"features": X, "label": logreg_ref["y"]}))
        nn = NearestNeighbors(k=KNN_K, num_workers=MD_CHIPS).setInputCol("features").fit(data)
        _, _, knn = fanned("knn", lambda: nn.kneighbors({"features": X[:KNN_QUERIES]}))
        del nn
        rows = {"features": X[:MD_TRANSFORM_ROWS]}
        split = fanned("transform", lambda: km_high.transform(rows))
    finally:
        km_ops.kmeans_fit = real_fit
        parallel.set_devices(None)
        config["fleet_ops_round_seconds"] = saved_interval
    counters = telemetry.registry().snapshot()["counters"]
    chip_rounds = counters.get("rendezvous.rounds", 0) - counters0.get("rendezvous.rounds", 0)
    ops = counters.get("fleet.ops_rounds", 0) - counters0.get("fleet.ops_rounds", 0)
    exits = {r: len(fleet.local_payload(r)["round_exits"]) for r in range(MD_CHIPS)}
    if not chip_rounds or ops or fleet.cluster_view() is not None or any(exits.values()):
        fail(f"19: the fanned fits ran {ops} ops rounds over {chip_rounds} chip rounds and left round exits {exits}")
    say(f"  19: the fanned fits ran {chip_rounds:g} rounds over the in-process rendezvous, no ops round, and left no "
        "round exits in the fleet plane")
    km_high.num_workers = 1
    _kernels.reset_launches()
    one = km_high.transform(rows)
    if not np.array_equal(split["prediction"].to_numpy(), one["prediction"].to_numpy()):
        fail("19 transform: the split transform's predictions differ from one chip's")
    if not counts["transform"].get("assign_argmin/f32") or set(counts["transform"]) != {"assign_argmin/f32"}:
        fail(f"19 transform: launches {counts['transform']} over two chips (B1 f32 alone expected)")
    say(f"  19 transform of {MD_TRANSFORM_ROWS} rows over two chips equals one chip's; B1 f32 launches "
        f"{counts['transform']['assign_argmin/f32']} over two chips (each block padded up the bucket ladder), "
        f"{_kernels.launches['assign_argmin/f32']} on one")
    # the launches the tiles imply: each chip's Lloyd pass runs its block's
    # tiles, kNN one d2_block per item block a chip
    tiles = sum(-(-(hi - lo) // TILE_ROWS) for lo, hi in parallel.shard_row_ranges(N_ROWS, MD_CHIPS))
    blocks = sum(-(-(hi - lo) // 16384) for lo, hi in parallel.shard_row_ranges(N_ROWS, MD_CHIPS))
    for name, form in (("kmeans_high", "f32"), ("kmeans_fast", "f32-fast")):
        got = counts[name].get(f"assign_accumulate/{form}", 0)
        if got == 0 or got % tiles or not counts[name].get(f"assign_argmin/{form}"):
            fail(f"19 {name}: launches {counts[name]} (B2 {form} a multiple of the chips' {tiles} tiles expected)")
    if counts["knn"] != {"d2_block/f32": blocks}:
        fail(f"19 knn: launches {counts['knn']}, expected d2_block/f32={blocks}")
    if counts["pca"] or counts["logreg"]:
        fail(f"19: PCA or LogisticRegression launched a kernel: {counts['pca']} {counts['logreg']}")
    # KMeans against one process summing the two blocks in chip order
    if len(inits) != 2 * MD_CHIPS or any(not np.array_equal(i, inits[0]) for i in inits[:MD_CHIPS]) or \
            any(not np.array_equal(i, inits[MD_CHIPS]) for i in inits[MD_CHIPS:]):
        fail(f"19 kmeans: {len(inits)} inits recorded, or the chips' inits differ")
    from spark_rapids_ml_tpu_torch.parallel import place_rows

    Xd, wd = place_rows(X, device=dev)
    ranges = parallel.shard_row_ranges(N_ROWS, MD_CHIPS)

    def ranked_step(c, fast):
        acc = None
        for a, b in ranges:
            part = tile_assign_accumulate(Xd[a:b], wd[a:b], c, TILE_ROWS, fast)
            acc = part if acc is None else tuple(x + y for x, y in zip(acc, part))
        return _finish_centers(*acc, c)

    for mode, model, init in (("high", km_high, inits[0]), ("fast", km_fast, inits[MD_CHIPS])):
        ranked = lloyd_loop(ranked_step, torch.from_numpy(init).to(dev), fast=mode == "fast", init_centers=init,
                            max_iter=MD_KMEANS["maxIter"], tol=MD_KMEANS["tol"])
        if not (np.array_equal(np.asarray(model.cluster_centers_), ranked["cluster_centers_"].cpu().numpy())
                and float(model.inertia_) == float(ranked["inertia_"])
                and int(model.n_iter_) == int(ranked["n_iter_"])):
            fail(f"19 kmeans {mode}: the two-chip fit differs from one process summing the same blocks in order")
    del Xd, wd
    torch.cuda.empty_cache()
    say("  19 kmeans high and fast: every chip's model equals rank 0's, and one process summing the two blocks "
        "in chip order from the same init gives the same centers, inertia and n_iter_ bit for bit")
    # kNN against phase 4
    ids = np.stack(knn["indices"].to_numpy())
    if not np.array_equal(ids, exact_ids) or not np.array_equal(knn["query_id"].to_numpy(), np.arange(KNN_QUERIES)):
        fail(f"19 knn: {int((ids != exact_ids).any(axis=1).sum())} query rows' ids differ from phase 4's")
    # PCA against 7a (phase 18's bounds)
    pca_res, spectrum = linear_ref["pca"], linear_ref["spectrum"]
    pert = 2 * F32_EIGH_REL * float(pca_res.explained_variance_[0])
    ev_err = float(np.abs(np.asarray(pca.explained_variance_) - pca_res.explained_variance_).max())
    if ev_err > pert:
        fail(f"19 pca: explained variance within {ev_err} of phase 7a's (Weyl bound {pert})")
    for i in range(PCA_K):
        gap = min(abs(spectrum[i] - spectrum[j]) for j in range(PCA_K + 1) if j != i) - 2 * pert
        cos = abs(float(np.asarray(pca.components_[i], dtype=np.float64) @ pca_res.components_[i]))
        if gap > 0 and pert / gap < 1 and cos < np.sqrt(1 - (pert / gap) ** 2):
            fail(f"19 pca: component {i}: |cos| {cos} below the Davis-Kahan bound")
    # the GLM against the same fit on one chip
    t0 = time.perf_counter()
    lr1 = LogisticRegression(**MD_LOGREG, num_workers=1).fit({"features": X, "label": logreg_ref["y"]})
    timings["logreg_one_chip_s"] = time.perf_counter() - t0
    f_err = abs(float(lr.objective_) - float(lr1.objective_)) / abs(float(lr1.objective_))
    lc_err = float(np.linalg.norm(np.asarray(lr.coef_) - np.asarray(lr1.coef_)) / np.linalg.norm(np.asarray(lr1.coef_)))
    if f_err > 1e-5 or lc_err > 1e-3:
        fail(f"19 logreg: objective within {f_err} (tol 1e-5), coefficients within {lc_err} (tol 1e-3) of one chip's")
    chips = timings["logreg"]["chips"]
    iter_ms = 1e3 * max(st["wall_s"] - st["placement_s"] for st in chips) / max(1, int(lr.n_iter_))
    timings["glm_iteration_ms"] = iter_ms
    say(f"  19 pca: explained variance within {ev_err:.3g} of 7a's (bound {pert:.3g}); logreg {MD_LOGREG}: "
        f"n_iter_ {int(lr.n_iter_)} ({int(lr1.n_iter_)} on one chip), objective within {f_err:.3g}, coefficients "
        f"within {lc_err:.3g}; a GLM iteration {iter_ms:.2f} ms over two chips (phase 8 12.05 ms on one, "
        "phase 18 35 ms on two gloo ranks); kNN ids equal to phase 4's")
    if not was_on:
        telemetry.disable()
    total = {}
    for c in counts.values():
        for k_, n in c.items():
            total[k_] = total.get(k_, 0) + n
    say("  launches in phase 19: " + ", ".join(f"{k_}={v}" for k_, v in total.items()))
    return total, timings


def phase_sched_coadmit(dev, X):
    """Phase 17e: benchmark/bench_scheduler.py's co-admission lane on phase
    19's pool, over the first COADMIT_ROWS protocol rows at full width: two
    KMeans jobs (COADMIT_KMEANS, each half the pool wide) co-admitted onto
    disjoint chips, then time-sliced (max_concurrent 1), and three jobs of
    which the third queues on chip overlap alone. Gates: peak occupancy 2
    chips, the co-admitted occupancy integral at least COADMIT_RATIO times the
    time-sliced one, every model equal bit for bit across schedules and to the
    job run alone, no admission over budget. Returns (launches, timings)."""
    import threading

    import torch

    from spark_rapids_ml_tpu_torch import FitScheduler, KMeans, parallel, telemetry
    from spark_rapids_ml_tpu_torch.ops import _kernels
    from spark_rapids_ml_tpu_torch.scheduler import global_ledger

    pool, what = _md_pool()
    width = max(1, MD_CHIPS // 2)
    say(f"phase 17e: sched_coadmit on {what}, two KMeans jobs {COADMIT_KMEANS} of width {width} over "
        f"{COADMIT_ROWS} x {N_COLS} float32 rows")
    data = {"features": X[:COADMIT_ROWS]}
    ledger = global_ledger()
    if ledger.reserved_bytes():
        fail("17e: the ledger holds claims before the phase")
    over = [0]

    def conformance(reserved, budget):
        if budget is not None and reserved > budget:
            over[0] += 1

    def mk():
        est = KMeans(**COADMIT_KMEANS)
        est.num_workers = width
        return est

    def schedule(max_concurrent, n_jobs=2):
        sched = FitScheduler(chip_placement=True, max_concurrent=max_concurrent)
        samples, stop = [], threading.Event()

        def poll():
            while not stop.is_set():
                samples.append((time.perf_counter(), len(ledger.occupied_chips())))
                stop.wait(0.002)

        sampler = threading.Thread(target=poll, daemon=True)
        t0 = time.perf_counter()
        sampler.start()
        try:
            jobs = [sched.submit(mk(), data, tenant=f"t{i}") for i in range(n_jobs)]
            st = sched.stats()
            models = [j.result(SCHED_TIMEOUT) for j in jobs]
        finally:
            stop.set()
            sampler.join(5.0)
            sched.shutdown(wait=True, timeout=60)
        wall = time.perf_counter() - t0
        closed = samples + [(t0 + wall, samples[-1][1] if samples else 0)]
        area = sum(v * max(0.0, t1 - ta) for (ta, v), (t1, _) in zip(closed, closed[1:]))
        peak = max((v for _, v in samples), default=0)
        return models, {"wall_s": wall, "avg_chips": area / max(1e-9, wall), "peak_chips": peak,
                        "rows_per_s": n_jobs * COADMIT_ROWS / wall}, st

    parallel.set_devices(pool)
    ledger.admission_hooks.append(conformance)
    was_on = telemetry.enabled()
    telemetry.enable()
    _kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        alone = mk().fit(data)
        alone_s = time.perf_counter() - t0
        three, _, st3 = schedule(max_concurrent=4, n_jobs=3)
        if not (st3["running"] == MD_CHIPS // width and st3["queued"] == 3 - MD_CHIPS // width):
            fail(f"17e: three jobs: {st3['running']} running, {st3['queued']} queued (the third queues on chips)")
        conc, c_stats, _ = schedule(max_concurrent=MD_CHIPS)
        sliced, s_stats, _ = schedule(max_concurrent=1)
    finally:
        ledger.admission_hooks.remove(conformance)
        parallel.set_devices(None)
        if not was_on:
            telemetry.disable()
    counts = {k_: n for k_, n in _kernels.launches.items() if n}
    for m in three + conc + sliced:
        if not np.array_equal(np.asarray(m.cluster_centers_), np.asarray(alone.cluster_centers_)):
            fail("17e: a scheduled model differs from the job run alone")
    chips = sorted(tuple(m._fit_metrics["scheduler"]["chip_ids"]) for m in conc)
    if chips != [tuple(range(i * width, (i + 1) * width)) for i in range(MD_CHIPS // width)]:
        fail(f"17e: the co-admitted jobs held chips {chips}, not disjoint halves")
    ratio = c_stats["avg_chips"] / max(1e-9, s_stats["avg_chips"])
    if c_stats["peak_chips"] != MD_CHIPS or ratio < COADMIT_RATIO or over[0]:
        fail(f"17e: peak {c_stats['peak_chips']} chips, occupancy ratio {ratio:.3f} (at least {COADMIT_RATIO}), "
             f"{over[0]} admissions over budget")
    torch.cuda.synchronize(dev)
    say(f"  17e: co-admitted {c_stats['wall_s']:.2f} s ({c_stats['rows_per_s']:.0f} rows/s, {c_stats['avg_chips']:.2f}"
        f" chips on average, peak {c_stats['peak_chips']}) against time-sliced {s_stats['wall_s']:.2f} s "
        f"({s_stats['rows_per_s']:.0f} rows/s, {s_stats['avg_chips']:.2f} chips): occupancy ratio {ratio:.3f}, rows/s "
        f"ratio {c_stats['rows_per_s'] / s_stats['rows_per_s']:.3f}; the job alone {alone_s:.2f} s; every model "
        "equal bit for bit; no admission over budget; launches " + ", ".join(f"{k_}={n}" for k_, n in counts.items()))
    return counts, {"concurrent": c_stats, "sliced": s_stats, "occupancy_ratio": ratio, "alone_s": alone_s}


def _mp_check_sweep(dev, X, got, info, y_cls):
    """18h's gates: on each rank one ingest and one layout for the whole
    sweep (the ranks' arrays were held equal with MP_MODEL_KEYS), then the
    parent's one-process sweep over the same rows in rank order: the same
    winner, every avgMetric within MP_SWEEP_METRIC_ATOL. Returns timings."""
    out = {}
    for r in range(MP_NRANKS):
        sw = info[r]["sweep"]
        c = sw["counters"]
        want = {"ingest.datasets": 1, "fit.device_dataset_builds": 1, "fit.device_dataset_reuses": CV_FOLDS}
        if any(c.get(k_) != v for k_, v in want.items()) or sw["layouts"] != 1:
            fail(f"18h: rank {r} counters {c}, layouts {sw['layouts']} (want {want} and one layout)")
        out[f"rank{r}"] = {"s": info[r]["fits"]["sweep"]["s"], "gathers": sw["gathers"], "counters": c}
        say(f"  18h rank {r}: sweep {info[r]['fits']['sweep']['s']:.2f} s over {MP_SWEEP_ROWS[r]} rows, counters {c}; "
            "held-out gathers by fold: " + ", ".join(
                f"{g_['rows']} rows {g_['bytes'] / 1e9:.3f} GB in {g_['s']:.3f} s" for g_ in sw["gathers"]))
    rows = np.concatenate([np.arange(MP_SWEEP_ROWS[r]) + _mp_bounds(r)[0] for r in range(MP_NRANKS)])
    # the ranks' folds: each rank draws its own over its rows, as
    # CrossValidator._kfold_indices draws them; the one-process sweep is
    # given the same ones as a fold column
    folds = np.concatenate([np.random.default_rng(CV_SEED).permutation(n) % CV_FOLDS for n in MP_SWEEP_ROWS])
    t0 = time.perf_counter()
    one = _sweep_validator(foldCol="fold").fit({"features": X[rows], "label": y_cls[rows], "fold": folds})
    out["one_process_s"] = time.perf_counter() - t0
    g = got[0]
    diff = np.abs(np.asarray(one.avgMetrics) - g["sweep_avg"])
    best_one = float(one.bestModel.getOrDefault("regParam"))
    out.update(avg_metrics=[float(v) for v in g["sweep_avg"]], one_process_avg_metrics=list(map(float, one.avgMetrics)),
               max_metric_diff=float(diff.max()))
    say(f"  18h: every rank's avgMetrics {np.round(g['sweep_avg'], 6).tolist()}, winner regParam "
        f"{float(g['sweep_best_reg']):g} and refit equal bit for bit; one process over the same {len(rows)} rows in "
        f"rank order and the ranks' folds ({out['one_process_s']:.2f} s): avgMetrics {np.round(one.avgMetrics, 6).tolist()}, winner "
        f"{best_one:g}; avgMetrics within {diff.max():.3g} (bound {MP_SWEEP_METRIC_ATOL})")
    if best_one != float(g["sweep_best_reg"]) or diff.max() > MP_SWEEP_METRIC_ATOL:
        fail(f"18h: the two-rank sweep's winner {float(g['sweep_best_reg'])} / avgMetrics {g['sweep_avg']} against "
             f"one process's {best_one} / {one.avgMetrics} (bound {MP_SWEEP_METRIC_ATOL})")
    return out


def _mp_check_recover(dev, X, kill_mark, killed_at, survivor):
    """18i's gates on the survivor (rank 1): alone in a one-rank group at
    generation 1, one recovery epoch and one rank lost, a checkpoint
    restored, its rows laid out again from their host blocks, and its
    centers equal bit for bit to one process's Lloyd run over its rows from
    the centers it resumed from. Returns timings."""
    import torch

    from spark_rapids_ml_tpu_torch.ops.kmeans import _lloyd_step, lloyd_loop
    from spark_rapids_ml_tpu_torch.parallel import place_rows

    c = survivor["counters"]
    ones = ("fit.recoveries", "recovery.epochs", "recovery.rank_losses", "rendezvous.reforms", "recovery.replacements")
    if (survivor["nranks"], survivor["generation"], survivor["live"]) != (1, 1, [1]) or any(c.get(k_) != 1 for k_ in ones) \
            or c.get("checkpoint.restores", 0) < 1 or survivor["resumed_iteration"] != [MP_RECOVER_KILL_AT]:
        fail(f"18i: the survivor: {dict((k_, v) for k_, v in survivor.items() if k_ not in ('centers', 'resumed'))}")
    for name in ("assign_argmin/f32", "assign_accumulate/f32"):
        if not survivor["launches"].get(name) or not kill_mark["launches"].get(name):
            fail(f"18i: {name} launches: rank 0 {kill_mark['launches']}, the survivor {survivor['launches']}")
    a, b = _mp_bounds(1)
    Xs, ws = place_rows(X[a:b], device=dev)
    start = torch.from_numpy(survivor["resumed"]).to(dev)
    t0 = time.perf_counter()
    ref = lloyd_loop(lambda cen, f: _lloyd_step(Xs, ws, cen, TILE_ROWS, f), start,
                     max_iter=MP_RECOVER_KMEANS["maxIter"] - MP_RECOVER_KILL_AT, tol=MP_RECOVER_KMEANS["tol"],
                     fast=False)
    ref_s = time.perf_counter() - t0
    same = np.array_equal(survivor["centers"], ref["cluster_centers_"].cpu().numpy())
    del Xs, ws
    torch.cuda.empty_cache()
    reform = survivor["reforms"][0]
    out = {"detect_s": reform["t0"] - killed_at, "reform_s": reform["s"], "group": survivor["group_reform_s"],
           "relayout_s": survivor["layouts_s"][-1], "layouts_s": survivor["layouts_s"], "fit_s": survivor["fit_s"],
           "rank0_mark_to_kill_s": killed_at - kill_mark["t"], "backend": survivor["backend"],
           "launches": {"rank0": kill_mark["launches"], "survivor": survivor["launches"]}, "reference_s": ref_s}
    say(f"  18i: rank 0 (the store's host) SIGKILLed {out['rank0_mark_to_kill_s']:.3f} s after its iteration-"
        f"{MP_RECOVER_KILL_AT} checkpoint; the survivor began the reform {out['detect_s']:.2f} s after the kill, "
        f"reformed in {out['reform_s']:.2f} s, tore the gloo group down in {out['group']['teardown_s']:.3f} s and "
        f"opened a one-rank {survivor['backend']} group in {out['group']['open_s']:.2f} s, laid its rows out again in "
        f"{out['relayout_s']:.2f} s (host blocks kept: recovery.replacements 1), resumed at iteration "
        f"{MP_RECOVER_KILL_AT} and ran to n_iter_ {survivor['n_iter']} ({survivor['fit_s']:.2f} s for the fit); "
        f"counters {c}; launches rank 0 {kill_mark['launches']}, the survivor {survivor['launches']}")
    if not same:
        fail("18i: the survivor's centers differ from one process's Lloyd run over its rows from the centers it "
             "resumed from")
    say(f"  18i: the survivor's centers equal one process's {MP_RECOVER_KMEANS['maxIter'] - MP_RECOVER_KILL_AT} "
        f"Lloyd iterations over rows [{a}, {b}) from the resumed centers bit for bit ({ref_s:.2f} s)")
    return out


def _mp_check_fleet(info, views, snapshots, survivor):
    """18j's gates on the ranks' fleet plane: each rank's last live view
    names every rank and misses none, is healthy, and merges at least two
    rendezvous rounds (one a rank) for each ops round; each rank ran an ops
    round on every top-level fit and sweep with none failed; both ranks'
    views of the last round have equal counters (one merge of the same
    payloads); the offline merge of the snapshots (`read_rank_snapshots`)
    names both ranks, none stale, missing or unreadable. 18i's survivor's
    failed ops rounds and trace exchanges are printed, not gated (the kill
    may fall between rounds). Returns timings."""
    out = {}
    names = [str(r) for r in range(MP_NRANKS)]
    for r in range(MP_NRANKS):
        f, v = info[r]["fleet"], views[r]
        if v is None or sorted(v["ranks"]) != names or v["missing"] != []:
            fail(f"18j: rank {r}'s cluster view names ranks {None if v is None else sorted(v['ranks'])}, "
                 f"missing {None if v is None else v['missing']}")
        if f["ops_rounds"] < f["scopes"] or f["ops_rounds_failed"]:
            fail(f"18j: rank {r} ran {f['ops_rounds']} ops rounds ({f['ops_rounds_failed']} failed) over "
                 f"{f['scopes']} top-level fits and sweeps")
        if not (v.get("health") or {}).get("healthy"):
            fail(f"18j: rank {r}'s cluster view is unhealthy: {v.get('health')}")
        merged_rounds = v["counters"].get("rendezvous.rounds", 0)
        if merged_rounds < MP_NRANKS * f["ops_rounds"]:
            fail(f"18j: rank {r}'s view merges {merged_rounds} rendezvous rounds for {f['ops_rounds']} ops rounds")
        out[f"rank{r}"] = {k_: f[k_] for k_ in ("ops_rounds", "scopes", "rounds", "rounds_s", "ops_s", "ops_wall_s")}
        say(f"  18j rank {r}: {f['ops_rounds']:g} ops rounds over {f['scopes']} top-level fits and sweeps, none "
            f"failed; their trace and ops rounds ({f['rounds']} rendezvous rounds) took {f['rounds_s']:.3f} s of "
            f"rendezvous.allgather_s, the ops rounds' allgathers {f['ops_s']:.3f} s and the ops rounds "
            f"{f['ops_wall_s']:.3f} s with their payloads and merges; its last view: ranks {sorted(v['ranks'])}, "
            f"missing {v['missing']}, healthy, {merged_rounds:g} rendezvous rounds merged; snapshot {f['snapshot']}")
    if views[0]["counters"] != views[1]["counters"]:
        diff = sorted(k_ for k_ in set(views[0]["counters"]) | set(views[1]["counters"])
                      if views[0]["counters"].get(k_) != views[1]["counters"].get(k_))
        fail(f"18j: the ranks' views of the last round differ in counters {diff[:10]}")
    reports, problems = snapshots
    ranks = sorted(int((rep.get("meta") or {}).get("rank", -1)) for rep in reports)
    if ranks != list(range(MP_NRANKS)) or problems["missing"] or problems["stale"] or problems["unreadable"]:
        fail(f"18j: the offline merge read ranks {ranks}, problems {problems}")
    sf = survivor.get("fleet") or {}
    out["18i"] = sf
    say(f"  18j: both views of the last round have equal counters ({len(views[0]['counters'])}); the offline merge "
        f"of the snapshots reads ranks {ranks}, none stale or missing; after 18i's kill the survivor ran "
        f"{sf.get('ops_rounds')} ops rounds, {sf.get('ops_rounds_failed')} failed, and recorded "
        f"{sf.get('trace_exchange_failed')} failed trace exchanges")
    return out


def _mp_checks_rest(dev, X, Xd, got, edges, y_cls, exact_ids, exact_dist, ann_ref, du_ref, sparse_ref):
    """The parent's gates of 18c-18g on the ranks' results `got` (and 18c's
    bin `edges`), with the protocol rows placed as `Xd`. Returns their
    timings and counts."""
    import torch

    from spark_rapids_ml_tpu_torch import RandomForestClassificationModel, RandomForestClassifier
    from spark_rapids_ml_tpu_torch.models.tree import _fill_empty_nodes, resolve_max_features
    from spark_rapids_ml_tpu_torch.ops.knn import exact_knn
    from spark_rapids_ml_tpu_torch.ops.trees import bin_features, grow_tree, split_bins_to_thresholds
    from spark_rapids_ml_tpu_torch.parallel import host_tensor

    out = {}
    g = got[0]
    # 18c: one tree of each rank regrown on one process, and the accuracy
    t0 = time.perf_counter()
    sp_ = RandomForestClassifier(**MP_FOREST)._solver_params
    classes = g["rf_classes"]
    T = int(MP_FOREST["numTrees"])
    tpd = -(-T // MP_NRANKS)
    params = {"max_depth": int(sp_["max_depth"]), "max_bins": int(sp_["n_bins"]),
              "max_features": resolve_max_features(sp_["max_features"], N_COLS, True),
              "impurity": sp_["split_criterion"], "bootstrap": bool(sp_["bootstrap"]),
              "subsample_rate": float(sp_["max_samples"]), "min_instances": float(sp_["min_samples_leaf"]),
              "min_info_gain": float(sp_["min_impurity_decrease"]),
              "draw_rows": max(b - a for a, b in (_mp_bounds(r) for r in range(MP_NRANKS)))}
    for r in range(MP_NRANKS):
        lo, hi = _mp_bounds(r)
        Xb = bin_features(Xd[lo:hi], host_tensor(edges.astype(np.float32)))
        onehot = (y_cls[lo:hi, None] == classes[None, :]).astype(np.float32)
        w = torch.ones(hi - lo, dtype=torch.float32, device=dev)
        f, b, ns = (t.cpu().numpy() for t in grow_tree(Xb, host_tensor(onehot).to(dev), w, int(sp_["random_state"] or 0),
                                                       r * tpd, params))
        del Xb
        f = f.astype(np.int32)[None]
        # rank r's first tree is place r of the forest's first (round-major) round
        same = (np.array_equal(f[0], g["rf_feature"][r])
                and np.array_equal(split_bins_to_thresholds(f, b[None], edges)[0], g["rf_threshold"][r])
                and np.array_equal(_fill_empty_nodes(f, ns[None].astype(np.float64))[0], g["rf_node_stats"][r]))
        if not same:
            fail(f"18c: tree {r * tpd} (rank {r}'s first) regrown on one process differs from the rank's")
    model = RandomForestClassificationModel(
        feature=g["rf_feature"], threshold=g["rf_threshold"], node_stats=g["rf_node_stats"], classes_=classes,
        num_trees=T, max_depth=int(MP_FOREST["maxDepth"]), n_cols=N_COLS, dtype="float32")
    rows = np.sort(np.random.default_rng(MP_FOREST_SAMPLE_SEED).choice(N_ROWS, MP_FOREST_SAMPLE, replace=False))
    pred = np.asarray(model.transform({"features": X[rows]})["prediction"])
    acc = float(np.mean(pred == y_cls[rows]))
    out["18c"] = {"check_s": time.perf_counter() - t0, "accuracy": acc, "split_nodes": int((g["rf_feature"] >= 0).sum())}
    say(f"  18c forest {MP_FOREST} ({tpd} trees a rank): the ranks' forests equal bit for bit; tree 0 of each rank "
        f"regrown on one process from the ranks' edges, its rows and a draw over {params['draw_rows']} rows equals "
        f"the rank's; training accuracy on {MP_FOREST_SAMPLE} fixed rows {acc:.4f} (floor {MP_FOREST_ACC_FLOOR}); "
        f"{out['18c']['split_nodes']} split nodes")
    if acc < MP_FOREST_ACC_FLOOR:
        fail(f"18c: training accuracy {acc} below {MP_FOREST_ACC_FLOOR}")
    # 18d: DBSCAN's labels and core rows equal 12a's
    labels = np.concatenate([gr["db_labels"] for gr in got])
    if not (np.array_equal(labels, du_ref["dbscan_labels"]) and np.array_equal(g["db_core"], du_ref["dbscan_core"])):
        fail(f"18d: the ranks' DBSCAN labels or core rows differ from 12a's ({int((labels != du_ref['dbscan_labels']).sum())} labels)")
    say(f"  18d DBSCAN: the ranks' labels ({', '.join(str(len(gr['db_labels'])) for gr in got)} rows) and core rows "
        "equal 12a's one-process labels exactly")
    # 18e: UMAP's embedding equals 12b's; each rank's transform the
    # one-process transform of its rows (rank 0's rows come first, so its
    # transform is 12b's rows: the transform's negative draws are positional)
    if not np.array_equal(g["um_emb"], du_ref["umap_embedding"]):
        fail(f"18e: the ranks' UMAP embedding differs from 12b's (max {np.abs(g['um_emb'] - du_ref['umap_embedding']).max()})")
    xu, _ = make_blobs(MP_UMAP_ROWS, UMAP_COLS, UMAP_CENTERS, 0)
    for r, gr in enumerate(got):
        a, b = _mp_share(MP_UMAP_ROWS, r)
        want = du_ref["umap_transform"][a:b] if r == 0 else np.stack(
            du_ref["umap_model"].transform({"features": xu[a:b]})["embedding"].to_list())
        if not np.array_equal(gr["um_transform"], want):
            fail(f"18e: rank {r}'s transform of its rows differs from the one-process transform")
    say("  18e UMAP: every rank's embedding equals 12b's bit for bit; each rank's transform of its rows equals the "
        "one-process transform of those rows (rank 0's: 12b's rows)")
    # 18f: IVFFlat over every list against phase 4's exact sets: where a
    # query's set differs, it may only swap rows whose exact (float64)
    # squared distances lie within the two float32 routes' error on that
    # query (B3's on phase 4's rows, IVFFlat's on its own) of each other
    def true_d2(ids):
        out_ = np.empty(ids.shape)
        for s0 in range(0, KNN_QUERIES, 256):
            q = Xd[s0:s0 + 256].double()
            c = Xd[torch.from_numpy(ids[s0:s0 + 256]).to(dev).long().clamp_min(0)].double()
            out_[s0:s0 + 256] = ((c - q[:, None, :]) ** 2).sum(2).cpu().numpy()
        return out_

    ids_all = np.concatenate([gr["ivfflat_all_ids"] for gr in got])
    d_all = np.concatenate([gr["ivfflat_all_dist"] for gr in got])
    t_exact, t_ivf = true_d2(exact_ids), true_d2(ids_all)
    tol = (np.abs(np.asarray(exact_dist, np.float64) ** 2 - t_exact).max(1)
           + np.abs(d_all ** 2 - t_ivf).max(1))
    differ, worst = 0, 0.0
    for qi in range(KNN_QUERIES):
        extra = ~np.isin(ids_all[qi], exact_ids[qi])
        if not extra.any():
            continue
        differ += 1
        missing = ~np.isin(exact_ids[qi], ids_all[qi])
        gap = t_ivf[qi][extra].max() - t_exact[qi][missing].min()
        worst = max(worst, gap / tol[qi])
        if gap > tol[qi]:
            fail(f"18f: IVFFlat over every list, query {qi}: a row {gap:.4g} farther than the exact set's row it "
                 f"replaces (the routes' float32 error {tol[qi]:.4g})")
    def recall(ids, ref):
        return float(np.mean([len(set(a[a >= 0]) & set(b)) / KNN_K for a, b in zip(ids, ref)]))

    out["18f"] = {"differing_sets": differ, "worst_swap_over_error": worst}
    for algo in ("ivfflat", "ivfpq"):
        rc = recall(np.concatenate([gr[f"{algo}_ids"] for gr in got]), exact_ids)
        one = ann_ref[algo]["recall_at_64"]
        out["18f"][f"{algo}_recall"] = rc
        if rc < one - MP_ANN_RECALL_MARGIN:
            fail(f"18f {algo}: recall@{KNN_K} {rc:.4f} below phase 11's {one:.4f} less {MP_ANN_RECALL_MARGIN}")
    cg = np.concatenate([gr["cagra_ids"] for gr in got])
    if ((cg < 0) | (cg >= MP_NRANKS * MP_CAGRA_ROWS)).any():
        fail(f"18f cagra: ids outside [0, {MP_NRANKS * MP_CAGRA_ROWS})")
    sub = torch.cat([Xd[a:a + MP_CAGRA_ROWS] for a, _ in (_mp_bounds(r) for r in range(MP_NRANKS))])
    _, cg_exact = exact_knn(sub, None, Xd[:KNN_QUERIES], k=KNN_K)
    del sub
    out["18f"]["cagra_recall"] = recall(cg, cg_exact)
    say(f"  18f IVFFlat over every list: each query's ids equal phase 4's set but for {differ} queries, whose swaps "
        f"are of rows within the float32 routes' error of each other (the worst at {worst:.3g} of it); recall@{KNN_K} at "
        f"phase 11's nprobe: IVFFlat {out['18f']['ivfflat_recall']:.4f} (one process "
        f"{ann_ref['ivfflat']['recall_at_64']:.4f}), IVFPQ {out['18f']['ivfpq_recall']:.4f} (one process "
        f"{ann_ref['ivfpq']['recall_at_64']:.4f}), margin {MP_ANN_RECALL_MARGIN}; CAGRA over the first "
        f"{MP_CAGRA_ROWS} rows of each rank: ids valid, recall@{KNN_K} {out['18f']['cagra_recall']:.4f}")
    # 18g: the sparse fits against 14a and 14b, the kNN against 14e
    f_err = abs(float(g["sp_lr_objective"]) - sparse_ref["logreg_objective"]) / abs(sparse_ref["logreg_objective"])
    c_err = float(np.linalg.norm(g["sp_ols_coef"] - sparse_ref["ols_coef"]) / np.linalg.norm(sparse_ref["ols_coef"]))
    knn_ids = np.concatenate([gr["sp_knn_ids"] for gr in got])
    out["18g"] = {"logreg_objective_rel": f_err, "ols_coef_rel": c_err, "logreg_iter": int(g["sp_lr_iter"])}
    if f_err > MP_SPARSE_OBJ_RTOL:
        fail(f"18g logreg: objective {float(g['sp_lr_objective'])} within {f_err} of 14a's (rtol {MP_SPARSE_OBJ_RTOL})")
    if c_err > MP_SPARSE_OLS_RTOL:
        fail(f"18g ols: coefficients {c_err} (normwise) from 14b's (bound {MP_SPARSE_OLS_RTOL})")
    if not np.array_equal(knn_ids, sparse_ref["knn_ids"]):
        fail(f"18g knn: {int((knn_ids != sparse_ref['knn_ids']).any(axis=1).sum())} query rows' ids differ from 14e's")
    say(f"  18g sparse, rows split {MP_SHARE:.0%} / the rest: LogisticRegression {SPARSE_LOGREG} n_iter_ "
        f"{int(g['sp_lr_iter'])}, objective within {f_err:.3g} of 14a's; OLS coefficients within {c_err:.3g} "
        f"(normwise) of 14b's; kNN ids equal 14e's")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs one card", file=sys.stderr)
        return 2
    if not (ROOT / "spark_rapids_ml_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--mp-worker"]:  # one rank of phase 18
        return mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_s = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        say(f"[{name}: {phase_s[name]} s]")
        return out

    smi = run("1 setup", phase_setup)
    entries = run("2 kernels", phase_kernels, dev)
    d2_entries = run("2 d2_block", phase_d2_block, dev)
    X = run("3 data", _protocol_rows)
    say(f"data {X.shape} float32")
    counts, timings, kmeans_model = run("3 kmeans", phase_main_path, dev, X)
    knn_counts, knn_timings, (exact_ids, exact_dist) = run("4 knn", phase_knn, dev, X, d2_entries[0]["ms"])
    serve_counts, serve_timings = run("5 serving", phase_serving, dev, X, kmeans_model)
    overload_counts, overload_timings = run("15 overload", phase_overload, dev, X, kmeans_model)
    linear_ref, linear_timings = run("7a pca/linear", phase_pca_linear, dev, X)
    logreg_ref, logreg_timings = run("8a logreg", phase_logreg, dev, X)
    recovery_counts, recovery_timings, recovery_refs = run("16 recovery", phase_recovery, dev, X, linear_ref,
                                                           logreg_ref["y"], linear_timings)
    sched_counts, sched_timings = run("17 scheduler", phase_scheduler, dev, X, logreg_ref["y"], recovery_refs)
    del recovery_refs
    forest_timings = run("9 forests", phase_forests, dev, X)
    multi_counts, multi_timings = run("10 multifit", phase_multifit, dev, X, linear_ref["y"], logreg_ref["y"])
    ann_counts, ann_timings = run("11 ann", phase_ann, dev, X, exact_ids, exact_dist)
    oocore_counts, oocore_timings = run("13 oocore", phase_oocore, dev, X, linear_ref, logreg_ref["y"])
    du_counts, du_timings, du_refs = run("12 dbscan/umap", phase_dbscan_umap, dev)
    sparse_counts, sparse_timings, sparse_refs = run("14 sparse", phase_sparse, dev)
    # phase 18 last of the float32 rows: 18f-18g hold to phases 11, 12 and 14
    mp_counts, mp_timings = run("18 multiprocess", phase_multiprocess, dev, X, linear_ref, logreg_ref,
                                exact_ids, exact_dist, ann_timings, du_refs, sparse_refs)
    del du_refs, sparse_refs
    md_counts, md_timings = run("19 multidevice", phase_multidevice, dev, X, linear_ref, logreg_ref, exact_ids)
    coadmit_counts, coadmit_timings = run("17e sched_coadmit", phase_sched_coadmit, dev, X)
    X = run("6 data f64", _f64_rows, X)  # the float32 rows are dropped here
    say(f"data as float64 {X.shape}")
    f64_counts, f64_timings = run("6 f64", phase_f64, dev, X)
    linear_f64_timings = run("7b pca/linear f64", phase_pca_linear_f64, dev, X, linear_ref)
    logreg_f64_timings = run("8b logreg f64", phase_logreg_f64, dev, X, logreg_ref)
    del X
    for e in entries + d2_entries:
        name = e["name"]
        if name == "d2_block/f64-fast":
            # its path is the degraded rung of a float64 kNN model (phase
            # 15b); the float64 route of phase 6 serves its kNN model as
            # float64
            e["launches"] = overload_counts[name]
            e["launches_by_run"] = {run: c[name] for run, c in f64_counts.items() if run != "route"}
        elif "/f64" in name:
            # the float64 route (phase 6) runs every f64 form but
            # assign_accumulate/f64-fast, which no path runs (a float64 fit
            # keeps `fast` off)
            e["launches"] = f64_counts["route"][name]
            e["launches_by_run"] = {run: c[name] for run, c in f64_counts.items() if run != "route"}
        elif name.startswith("d2_block"):
            # kneighbors runs f32, serving f32-fast
            e["launches"] = serve_counts[name] if name.endswith("-fast") else knn_counts[name]
            e["launches_by_run"] = {"kneighbors": knn_counts[name], "serving": serve_counts[name],
                                    "ann": ann_counts[name]}
        else:
            e["launches"] = counts["main_path"][name]
            e["launches_by_run"] = {run: c[name] for run, c in counts.items() if run != "main_path"}
            e["launches_by_run"]["serving"] = serve_counts[name]
            e["launches_by_run"]["fit_multiple"] = multi_counts[name]
            e["launches_by_run"]["ann"] = ann_counts[name]
            e["launches_by_run"]["oocore"] = oocore_counts["oocore"].get(name, 0)
    entries += d2_entries
    for e in entries:  # phase 12: DBSCAN launches nothing, UMAP only d2_block/f32
        e.setdefault("launches_by_run", {}).update({run: c[e["name"]] for run, c in du_counts.items()})
        e["launches_by_run"]["sparse_knn"] = sparse_counts["sparse_knn"][e["name"]]  # phase 14e
        e["launches_by_run"]["overload"] = overload_counts[e["name"]]  # phase 15
        e["launches_by_run"]["recovery"] = recovery_counts.get(e["name"], 0)  # phase 16
        e["launches_by_run"]["scheduler"] = sched_counts.get(e["name"], 0)  # phase 17
        e["launches_by_run"]["multiprocess"] = mp_counts.get(e["name"], 0)  # phase 18, both ranks
        e["launches_by_run"]["multidevice"] = md_counts.get(e["name"], 0)  # phase 19, both chips
        e["launches_by_run"]["sched_coadmit"] = coadmit_counts.get(e["name"], 0)  # phase 17e
    for name in ("assign_argmin/f64", "assign_accumulate/f64", "d2_block/f64", "assign_argmin/f64-fast"):
        if not f64_counts["route"][name]:
            fail(f"the float64 route never launched {name}")
    for name in ("d2_block/f64-fast", "d2_block/f64", "assign_argmin/f32-fast", "assign_argmin/f32"):
        if not overload_counts[name]:
            fail(f"the overload path (phase 15) never launched {name}")
    for name in ("assign_argmin/f32", "assign_accumulate/f32", "assign_argmin/f32-fast", "assign_accumulate/f32-fast"):
        if not recovery_counts.get(name):
            fail(f"the recovery path (phase 16) never launched {name}")
        if not sched_counts.get(name):
            fail(f"the scheduler path (phase 17) never launched {name}")
        if not md_counts.get(name):
            fail(f"the multi-device path (phase 19) never launched {name}")
    for name in ("assign_argmin/f32-fast", "assign_accumulate/f32-fast"):
        if not coadmit_counts.get(name):
            fail(f"the co-admission path (phase 17e) never launched {name}")
    if not md_counts.get("d2_block/f32"):
        fail("the multi-device path (phase 19) never launched d2_block/f32")
    say("KMeans path timings: " + json.dumps(timings))
    say("kNN path timings: " + json.dumps(knn_timings))
    say("serving timings: " + json.dumps(serve_timings))
    say("overload and ops plane timings: " + json.dumps(overload_timings, default=str))
    say("float64 route timings: " + json.dumps(f64_timings))
    say("PCA and LinearRegression timings: " + json.dumps(linear_timings))
    say("PCA and LinearRegression float64 timings: " + json.dumps(linear_f64_timings))
    say("LogisticRegression timings: " + json.dumps(logreg_timings))
    say("LogisticRegression float64 timings: " + json.dumps(logreg_f64_timings))
    say("RandomForest timings: " + json.dumps(forest_timings))
    say("multi-fit engine timings: " + json.dumps(multi_timings))
    say("ApproximateNearestNeighbors timings: " + json.dumps(ann_timings))
    say("DBSCAN and UMAP timings: " + json.dumps(du_timings))
    say("out-of-core timings: " + json.dumps(oocore_timings))
    say("sparse input timings: " + json.dumps(sparse_timings))
    say("recovery timings: " + json.dumps(recovery_timings))
    say("scheduler timings: " + json.dumps(sched_timings))
    say("multi-process timings: " + json.dumps(mp_timings))
    say("multi-device timings: " + json.dumps(md_timings))
    say("co-admission timings: " + json.dumps(coadmit_timings))
    say("seconds by phase: " + json.dumps(phase_s))
    kernels_line = json.dumps({"kernels": entries})
    say(f"total {time.perf_counter() - t_start:.1f} s")
    LOG_DIR.mkdir(exist_ok=True)
    (LOG_DIR / "chip_smoke.log").write_text("\n".join(_log_lines + [kernels_line, smi]) + "\n")
    print(kernels_line)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
