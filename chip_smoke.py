"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (every check is against the plain PyTorch version on
the card, f64 at rtol 1e-12 / atol 1e-16, f32 at the loose bars of
``_check``):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles ``landhydrology_tpu_torch/csrc/column_kernel.cu``,
   ``csrc/implicit_kernel.cu``, ``csrc/land_kernel.cu``,
   ``csrc/rk_kernel.cu`` and ``csrc/tile_columns_kernel.cu`` (the
   column-tile kernel, which phase 12 launches) with nvcc, one process per
   source and float type,
   in parallel, and starts ``csrc/implicit_most_columns_kernel.cu``,
   ``csrc/implicit_most_kernel.cu``,
   ``csrc/implicit_branch_kernel.cu``, ``csrc/land_policy_kernel.cu``,
   ``csrc/land_rk_kernel.cu``, ``csrc/land_policy_rk_kernel.cu``,
   ``csrc/land_columns_kernel.cu``, ``csrc/land_policy_columns_kernel.cu``,
   ``csrc/implicit_policy_kernel.cu`` (the plain soil's implicit policy
   instances, out of ``implicit_kernel.cu`` since phase 20's cut),
   ``csrc/rk_columns_kernel.cu`` and ``csrc/implicit_columns_kernel.cu`` in
   the background at nice 19, four compiles at a time, the longest first
   (``LaterBuild``, ``LATER_ORDER``), which phases 14-21 (and the end) wait for;
   prints the registers of every template instance; reads the instruction
   cost of exp, log, sqrt and a division from ``cuobjdump -sass`` of small
   kernels (``op_costs``), for the bounds;
3. goldens in f64 through the kernels (rtol 1e-12, atol 1e-16): golden #1
   against ``golden_coupled_f64.npz`` in modes B1 and B1-no-ice, and against
   ``golden_lagged_f64.npz`` in B2 and B2-no-ice (64 steps of dt=10); the
   freeze golden against ``golden_freeze_f64.npz`` in B3-rate, and in B3-eq,
   B2+B3-rate and B2+B3-eq against the plain version (64 steps of dt=5);
   golden #1 under ``TRBDF2Soil(iters=3)`` against ``golden_implicit_f64.npz``
   (16 steps of dt=120; Thomas at rtol 1e-12, PCR within atol 1e-9), and
   under ``BackwardEulerSoil`` / ``BackwardEulerRichards`` against the plain
   version; the JAX fused tests' implicit cases (the stiff infiltration at
   20x CFL, heterogeneous parameters, PCR against Thomas); then BC/parameter
   variants on 1,000 columns in B1, B2, B3-rate, B3-eq, B1-water, B1-heat,
   B4-trbdf2-water and B4-trbdf2-heat, f64 and f32;
4. the main paths at full width: ``Simulation(model, SSPRK33(),
   engine="fused")`` on the benchmark configuration (nz=64, ncol=65,536,
   steps_per_call=32, 96 steps of dt=1, saved every 32 steps) in float32 and
   float64, with stage coefficients (B1), lagged ones
   (``coefficient_update="step"``, B2), and each with ``assume_no_ice``;
   the launch counts are set to 0 just before each run and read just after;
   each is compared with the plain version and, change against change, from
   the start state (``_check_increment``; in f64 by the path's first launch
   since phase 20's cut of plain launches); the lagged runs print their
   largest deviation from the stage run (``bench.py``'s ``max_dev_lagged``);
5. freeze-thaw at full width: the freeze golden's column at nz=64 x 65,536
   with moisture and temperature varied by column, under ``FreezeThaw(tau=60)``
   (B3-rate) and ``EquilibriumFreezeThaw()`` (B3-eq), 64 steps of dt=5 in two
   launches, f32 and f64, driven and checked as in phase 4 (held to the
   plain version by their first launch since phase 19, f32's B3-eq since
   phase 20 with its change bar on the total water and rho_e_int, which no
   projection moves); ice must form;
8. the stiff path at full width (``bench.py``'s ``implicit`` path):
   ``bench.py::build_stiff`` at nz=64 x 65,536, ``dt_exp`` as bench.py
   computes it; ``TRBDF2Soil(iters=2)`` at 40 dt_exp, 8 steps in one launch
   (Thomas, and PCR), and SSPRK33 at dt_exp over the same horizon (320
   steps, 8 launches, held to the plain version by its first since phase
   19), f32 and f64, driven and checked as in phase 4, with
   the matched-horizon RMSE (below 1e-2, bench.py's gate) and maximum
   deviation, and each path's wall time end to end;
9. the other new modes at full width: B1-heat and B4-trbdf2-heat on a
   heat-only column, B4-trbdf2, B4-be-soil and B4-be-richards on the
   benchmark configuration, B4-be-richards-water on the stiff column, f32
   and f64, driven and checked as in phase 4 (each held by its first launch
   since phase 20);
10. the land path (``bench.py``'s ``land`` path, kernel modes B5 and B6):
   f64 checks at the JAX fused tests' sizes (``test_pallas_kernel.py:215``
   in B5, ``:278`` in B6 with a pond forming, ``test_land_model.py:862`` in
   B6-step, which must differ from B6), 1,000-column variants with
   per-column atmosphere fields over both Businger branches in B5, B2+B5,
   B6, B6-step, B2+B6-step and the four B6 names with ``-pond``, f64 and
   f32 (8 steps; 2 in f64 since phase 19); the eager engine against ``golden_land_f64.npz`` (routing included)
   at rtol 1e-12; then ``bench.py::build_land`` at nz=64 x 65,536, 32 steps
   of dt=1 in one launch, f32 and f64, in the reference setting (B6), the
   production setting (B2+B6-step), B6-step, B2+B6, B6-pond, and its soil
   alone in B5 and B2+B5, and its plain top under the pond in B6-pond,
   B6-step-pond, B2+B6-pond and B2+B6-step-pond, driven and checked as in
   phase 4 (the pond too; all but f32's MOST soil held by a launch of 4
   steps, since phase 19, B6 and B2+B6-step since phase 20), with each land
   run's water
   budget, the host
   time per launch and the largest deviation of B2+B6-step from B6;
11. the forced-reanalysis path (kernel mode B7, streamed forcing rows):
   f64 checks at the JAX tests' sizes (``golden_forced_f64.npz`` at rtol
   1e-12 through B5+B7; ``test_forcing_driver.py:191`` with a scalar row
   and a remainder launch, ``:225`` with per-column rain ponding a
   LandModel, ``:544`` with time-indexed rows clamped at both table ends,
   equal bit for bit to the step-indexed rows), 1,000-column variants of
   every B5/B6 mode with forcing rows (both Businger branches, step- and
   time-indexed), f64 and f32; then ``experiments/soil/forced_reanalysis.py``'s
   LandModel at nz=24 x 131,072 (``build_reanalysis``), 240 steps of dt=120
   of its forcing (``reanalysis_forcing``, written to a temporary file)
   through ``run_forced`` (windows of 120, 24 steps per launch, pinned
   staging), f32 and f64, with and without overlap: (a) equal bit for bit
   to the in-memory fused segment, (b) every 128th column equal to the
   plain version on those columns' rows over the first launch, (c)
   the water budget within 1% of the largest column's rain, (d) prefetch
   hits and the native reader; prints grid-points/s end to end with the
   IO, kernel ms per launch, the host's ms per window (reader, pinned
   copy, H2D copy), the device busy share and the bound of B6+B7; then
   three more paths over the first window, each with its own launch
   count, checked against the plain version on the strided columns and
   timed: the production setting (B2+B6-step+B7), the soil alone under
   the atmosphere rows (B5+B7) and time-indexed rows on a grid of 2 dt
   (B6+B7-time); then one launch each of the other B5/B6 modes with rows
   (B2+B5, B6-step, B2+B6 and the four ``-pond`` modes) at nz=24 x 32,768,
   checked against the plain version (in f64 by a launch of their first 8
   rows since phase 19) and timed;
12. the regional-grid path (kernel modes B1-batched and B8): f64 checks at
   the JAX tests' sizes (``test_batched_heterogeneous.py:59``'s three
   bottom kinds, ``test_variable_depth.py:237``'s 8 variable-depth columns
   and ``:272``'s BackwardEulerRichards on three depths; ``streamed_geometry``
   of the model's own grid equal bit for bit to the model-grid run), then
   1,000-column variants, f64 and f32, of every mode that takes per-column
   BC kinds or depths (``GRID_VARIANTS``: kinds drawn at both faces for
   both components, depths from U(0.8, 3.0) m, and the two cross-component
   Dirichlet cases); then ``experiments/soil/regional_grid.py``'s hour at
   nz=48 x 131,072 (``build_regional``: per-column soils and BC kinds, 720
   steps of dt=5 in 15 launches) and its variable-depth twin, f32 and f64,
   each through the script's loop of ``make_fused_column_run`` calls and
   ``Simulation(engine="fused")`` (equal bit for bit, launch counts set to 0
   just before each and read just after), the first launch at full width
   against the plain version (dt=5 s is past the explicit limit of a few
   columns that saturate, in the JAX package too: the kernel and the plain
   version must diverge in the same columns), with at most 4,096 columns
   out of the range over the hour and the script's summary on the other columns (vartheta_l within [0, nu],
   Dirichlet columns wetter, the water-mass change) and grid-points/s,
   kernel ms per launch and the bound; one timed launch of each other
   kinds / B8 instance at nz=48 x 32,768 (the implicit ones at dt 30 s,
   every column finite); and the lateral surface coupling on the eager engine
   (``tests/parallel/test_sharding.py``'s 8 x 8 batch): water conserved to
   1e-12, the surface bump flattening;
13. adaptive stepping (``landhydrology_tpu_torch/adaptive.py``, kernel
   modes B1-dt and B4+B5, B4+B5+B7): (a) f64 at the JAX tests' sizes, the
   adaptive golden (``golden_adaptive_f64.npz``) through the kernels: case
   a (golden #1 under ``run_adaptive_fused``) with JAX's counts, its dt
   after every iteration within the reference's one-ulp spread and the
   state at rtol 1e-10; case b (TR-BDF2 under a MOST top with time-indexed
   rows, ``run_adaptive_forced(engine="fused")``) free within the
   reference's one-ulp spread and replaying the golden's iteration records
   (error norms within the noise bar, the final state at rtol 1e-10); every
   JAX adaptive test of ``ADAPTIVE_TESTS`` replaying its records and free
   with JAX's counts; the first 8 iterations of each kernel-driven run
   replayed through the plain version on the card (``_check``'s bars, the
   error norms); (b) one launch
   at ``dt_run`` = 0.37 x the factory dt in every mode of the kernel table
   (52 names, the B4+B5 instances included) on 1,000 columns, f64 and f32,
   equal bit for bit to a run built at that dt, and within the plain
   version's bars for the implicit steppers under MOST without rows alone,
   whose records carry the error (a cut for the script's time: each mode's
   instance meets the plain version at its own step elsewhere); (c) at
   full width, f32 and f64: ``bench.py::build`` under
   ``run_adaptive_fused(SSPRK33(), steps_per_call=32)`` for an hour from dt0
   = 1 s (B1), ``build_stiff`` over phase 8's horizon under TR-BDF2 and
   SSPRK33 (8 steps per segment; RMSE against SSPRK33 at dt_exp below
   1e-2), the reanalysis LandModel under the first 12 rows of its forcing
   as a time-indexed table (B6+B7-time; in f32 alone since phase 18's cut)
   and its soil under TR-BDF2
   (B4-trbdf2+B5+B7-time), dt_max 120 s; each with its launch counts set
   to 0 just before the run and read just after, counts, rates, kernel ms
   per launch, busy share and host time per iteration, the first
   iteration's first half-step launch against the plain version on 1,024
   evenly spaced columns, and the final state against a fixed-dt kernel run at the
   largest accepted dt / 8 (within the tolerance the controller accepted);
   then the B4+B5 modes timed at nz=24 x 32,768 (the plain version over
   one step on every 256th column since phase 19);
14. the gradient path (ROADMAP A17, kernel modes B9 and B4 with step
   policies): (a) f64, ``golden_grad_f64.npz`` through
   ``make_fused_column_run(differentiable=True)`` (the kernel's forward, one
   launch each): the loss at rtol 1e-12 and the gradients in the start
   state, t0 and dt_run within 1e-10 of their scale; on the land golden's
   soil (MOST) under SSPRK33, lagged and TR-BDF2, AD within rtol 1e-7 of
   the JAX package's forward differenced; on
   ``test_differentiability.py``'s column, AD against central differences on
   three random directions (rtol 5e-5) and d/d dt not zero and within 1e-5
   of its difference; (b) every plain-soil mode of the kernel table (the
   SSPRK33 modes, each implicit stepper alone and with each step policy,
   the branches, kinds and depths, a MOST top under SSPRK33, lagged and
   TR-BDF2) as a B9 forward on 1,000 columns, those of ``B9_MODES``, f64
   and f32: equal bit for bit to the non-differentiable run, the gradient finite
   and within the repo's bars of autograd through the whole launch's plain
   version; then each B4 + policy instance (and each implicit stepper
   without one) at nz=64 x 16,384, 4 steps of 60 s on the freeze column,
   against the plain version (``_check_freeze``, ``_check_increment``) and
   timed in the same pass as phase 6 times its paths; (c) at full width, f32 and f64, ``bench.py::build`` under
   SSPRK33 (16 steps, B9:B1) and ``build_freeze_wide`` under
   ``TRBDF2Soil(iters=2)`` with rate freeze-thaw (2 steps of 60 s,
   B9:B4-trbdf2+B3-rate; 32 and 8 steps until phase 20's depth cut, 4
   until phase 21's), with
   the launch count set to 0 just before and
   read just after: the forward against the plain version, the forward's
   and the backward's ms, the backward's peak memory, each field's
   gradient norm and, in f64, one directional central difference (rtol
   1e-4);
15. the run-file CLI (ROADMAP A16) and the explicit steppers of
   ``csrc/rk_kernel.cu`` (ForwardEuler, SSPRK22, SSPRK104; ROADMAP B1): (a)
   every new (stepper, mode) instance on 1,000 columns, 2 steps, f64 and
   f32, against the plain version (``_check`` or the freeze bars, and
   ``_check_increment``) and as a B9 forward equal bit for bit to its
   launch; the no-ice ones also on an icy state (``rk_icy``), with
   ``column_kernel.cu``'s B1-no-ice and the three B4 ``-no-ice`` instances
   (dt 60 s) held there too (ROADMAP C, repaired); then each timed at nz=64 x 65,536,
   4 steps per launch, on the column its SSPRK33 mode runs at width; (b) ``bench.py::build``'s model at
   nz=64 x 65,536 with Ksat drawn per column from ``--seed``, written by
   ``config.to_config`` into a run file (hydrostatic state, SSPRK104,
   ``"engine": "pallas"``, f64) and run by ``python -m
   landhydrology_tpu_torch run`` in subprocesses: 96 steps in 3 launches with
   a save per launch and a checkpoint, a resumed run for one more launch
   equal bit for bit to a straight 128-step run, whose first launch on
   every 64th column is held against the plain version (128 steps before
   phase 18's cut); the CLI's launch counts and host time,
   and one 32-step launch of each explicit stepper at that width, f32 and
   f64 (kernel ms against the plain version, and against the predictions
   in PERF.md); in a whole run the CLI runs, and is checked, beside 17a's
   f64 checks (``CliAhead``), and 15b keeps its times; (c) each stepper's
   temporal order in f64 through its
   kernel under a time-varying flux top (slopes within 0.35 of 1, 2, 3, 4);
16. the cold land path (kernel modes B5 and B6 with freeze-thaw or
   ``assume_no_ice``, each alone or with lagged coefficients:
   ``csrc/land_policy_kernel.cu``, ``COLD_MODES``): (a) every instance on
   1,000 columns of ``build_land_variant``'s column made cold (268-278 K by
   column, 0.02 of ice, theta_atm within 8 K), 4 steps of 2 s (2 in f64
   since phase 18's cut), f64 and f32,
   with per-column forcing rows (theta_atm within 8 K of 273.15 K under MOST,
   rain on a LandModel: ``B5+B3-rate+B7``, ...; the cut that pays for phase
   17's checks of the rows), against the plain version (the freeze bars of
   ``_check_freeze`` with freeze-thaw, else ``_check``;
   ``_check_increment``), ice growing in some columns and melting in others
   under freeze-thaw and unchanged without it; the no-ice ones on the icy
   state too, without rows; (b) ``bench.py::build_land``'s
   LandModel around ``build_freeze_wide``'s cold column (theta_atm 263.15
   K) at nz=64 x 65,536, one launch of 32 steps of 5 s, f32 and f64, in
   ``B6+B3-rate``, the production setting ``B2+B6-step+B3-rate`` and
   ``B6+B3-eq`` (``COLD_PATHS``) through ``Simulation(engine="fused")``,
   checked as in phase 4 (the pond too; each by a launch of 4 steps, the
   first since phase 20, the last two
   since phase 19), ice formed, the water budget
   closed, the kernel (CUDA events) and its check's plain launch timed, the
   host share; (c) every other instance timed at that width, one launch of
   4 steps (kernel only; the plain version not timed there), beside its
   bound;
17. cold forced and water-only land (kernel modes B5/B6 + B7 under the step
   policies, the LandModel on a water-only soil, B4+B5 with the step
   policies): (a) on 1,000 columns of 16a's cold column, 4 steps (2 in
   f64), f64 and
   f32, against the plain version as in 16a (which holds the 30 land
   policy instances with step-indexed rows): the MOST tops' rate instances
   with time-indexed rows, the 8 water-only LandModel instances (T prescribed
   at 270-275 K, ``TemperatureDependentViscosity``; ``B6-pond-water``, ...)
   with and without rain rows, the 24 implicit instances at dt = 60 s, 2
   steps (4 before phase 18's cut)
   (``B4-trbdf2+B2+B5`` to ``B4-be-richards-no-ice+B2+B5``, and lagged with
   no ice on the plain soil), two of them with both row kinds; the new
   no-ice instances also on the icy state; (b) the cold season's forced
   reanalysis: ``forced_reanalysis.py``'s LandModel under
   ``FreezeThaw(tau=3600)`` at 273.4-275.4 K, nz=24 x 131,072, 48 rows of
   its forcing with theta_atm 24 K lower (two windows; from step 70-74 the
   rain band falls on frozen ground and the explicit step leaves the finite
   numbers there, in the JAX package as in the port,
   ``tests/test_torch_cold_forced_divergence.py``) through ``run_forced``
   from a file, in ``B6+B3-rate`` and ``B2+B6-step+B3-rate``, f32 and f64:
   the first launch against the plain version on every 128th column, ice
   formed, the water budget, the kernel's time and the reader's and host's
   shares; (c) ``catchment.py``'s storm on its water-only soil at 512 x 512
   columns (no routing, a uniform 2 m depth: the instances without
   ``MODE_COLUMNS``; 19a runs its own depth), nz=16, 32 steps of 2 s from
   t0 = 1,700 s in ``B6-pond-water`` and ``B2+B6-step-pond-water``: every
   256th column against the plain version, a pond formed, the water budget;
   (d) TR-BDF2 under 16b's cold MOST top at nz=64 x 65,536, one launch of 8
   steps of 60 s, in ``B4-trbdf2+B3-rate+B5`` and
   ``B4-trbdf2+B2+B3-eq+B5`` (in f64 held by a launch of 2 steps, the first
   since phase 20, the second since phase
   19),
   driven and checked as in phase 4 (the f32
   equilibrium path's change bar on the total water and rho_e_int, which
   the projection does not re-partition), ice formed;
   (e) every other new instance timed at the width of its path, and the 30
   land policy instances with rows at 16c's width (rows that carry the
   model's own values), one launch of 4 steps (kernel only), beside the
   bound;
18. the explicit steppers under a MOST top and a LandModel (the land body's
   stage table, ROADMAP B1) and the implicit steppers' policies on the
   water-only branch (``csrc/implicit_branch_kernel.cu``, ROADMAP B4): (a)
   ``bench.py``'s stiff path with lagged coefficients
   (``B4-trbdf2-water+B2``) at nz=64 x 65,536, 8 steps of
   ``STIFF_LAGGED_FACTOR`` dt_exp in one launch (lagging K leaves the
   physical range past 5 dt_exp, in the JAX package too), f32 and f64,
   driven and checked as in phase 8, its deviation from the stage run held
   to bench.py's max_dev_lagged bar 1e-2, timed in phase 6; (b)
   ``bench.py::build_land``'s LandModel at nz=64 x 65,536 in the reference
   (B6) and production (B2+B6-step) settings, each written by
   ``config.to_config`` into a run file (hydrostatic, a pond, SSPRK104,
   ``"engine": "pallas"``, f64) and run by ``python -m
   landhydrology_tpu_torch run`` in a subprocess, 96 steps in 3 launches
   saved at each: equal bit for bit to a straight ``Simulation`` of the
   file, the instance timed at width; then one launch of 32 steps of
   ``B6@ForwardEuler`` and ``B6@SSPRK22`` at that width, f32 and f64, and
   the two SSPRK104 instances in f32, each timed at width; each instance
   held by a launch of 4 steps against the plain version on every 256th
   column (timed); in a whole run the two CLIs run, and are checked, beside
   17a's f64 checks with 15b's (``CliAhead``), and 18b keeps its times of
   the other steppers; (c) each of the 48 land instances without
   ``MODE_COLUMNS`` once per float type under ForwardEuler, SSPRK22 or
   SSPRK104 (``land_rk_cases``: the steppers cycled, a third with forcing
   rows) on 1,000 cold columns, 2 steps (4 in f32), against the plain
   version as in 16a, each timed at width (16c's cold column, 17c's storm
   for the water-only ones); (d) the six water-branch policy instances and
   PCR on two on ``build_stiff``'s column (1,000 columns, 2 steps of 5 s),
   the no-ice ones also on the icy state, f32 and f64, each timed at
   18a's width and step;
19. per-column BC kinds and geometry in the land modes (kernel modes
   B1-batched and B8 under a MOST top and a LandModel:
   ``csrc/land_columns_kernel.cu`` and ``csrc/land_policy_columns_kernel.cu``,
   every explicit stepper from the stage table, and ``csrc/land_kernel.cu``'s
   SSPRK33 B5 and B6; ROADMAP B item 1), f64 and f32: (a) ``catchment.py``'s
   storm at its regolith depth (0.5-2 m by column, ``VariableDepthColumn``)
   on 512 x 512 columns, nz=16, 32 steps of 2 s from t0 = 1,700 s in
   ``B6-pond-water+B8`` and ``B2+B6-step-pond-water+B8`` through
   ``Simulation(engine="fused")``: every 256th column against the plain
   version, a pond formed, the water budget with each column's dz, the
   kernel's time, bound and the host's share; (b) its ``--atmos`` soil
   (coupled, under MOST, from 292 K) there in ``B2+B6-step+B8`` and in
   ``land_kernel.cu``'s ``B6+B8``, checked alike but for the rain budget
   (the exchange evaporates); (c) each of the 48 land instances with
   ``MODE_COLUMNS`` on 1,000 cold columns with per-column BC kinds (bottom
   hydrology flux / Dirichlet / free drainage, energy flux / Dirichlet, a
   plain top's energy too) and depths (``with_columns``), under ForwardEuler,
   SSPRK22, SSPRK33 or SSPRK104 (``land_columns_cases``: each family meets
   every stepper, a third with forcing rows), 2 steps (4 in f32), against
   the plain version as in 16a; (d) each timed at 16c's width (17c's storm
   for the water-only ones) with the same kinds and depths, one launch of 4
   steps (kernel only), beside its bound;
20. per-column BC kinds and geometry in the plain-soil modes (kernel modes
   B1-batched and B8: ``csrc/rk_columns_kernel.cu`` under every explicit
   stepper from the stage table, ``csrc/tile_columns_kernel.cu`` for B1 and
   B1-no-ice under each of them, ``csrc/implicit_columns_kernel.cu`` under
   every implicit step policy; ROADMAP B item 2, plain-soil part): (a)
   ``regional_grid.py``'s hour as phase 12 drives it, with
   ``production_run.py``'s ``assume_no_ice=True`` (``B1-no-ice+kinds`` and
   its variable-depth twin ``B1-no-ice+kinds+B8``), f32 and f64, the first
   launch against the plain version, ``Simulation(engine="fused")`` equal bit
   for bit to the script's loop, its diverged columns those of phase 12's B1
   hour, then timed as phase 6 times its paths; (b) the twin with lagged
   coefficients as a run file (SSPRK104, ``"engine": "pallas"``, a constant
   start) through ``python -m landhydrology_tpu_torch run``
   (``B2+kinds+B8@SSPRK104``, 2 launches of 48 steps), its first save equal
   bit for bit to the file's first launch in this process, that launch on
   every 64th column against the plain version; (c) each of the 44 new
   instances on 1,000 columns of ``build_grid_variant``'s kinds (both faces,
   both components) and depths, the freeze-thaw and no-ice ones from 16a's
   cold start (the explicit no-ice ones on its icy state), the explicit
   steppers rotated
   through each family (``soil_columns_cases``) over 2 steps in f64 and 4
   in f32, the implicit ones over 2 steps of 30 s, two also with PCR, f64
   and f32, against the plain version; (d) each timed at phase 12's variant
   width (nz=48 x 32,768, phase 12's warm start, the dt scaled by (16/48)^2
   with the spacing),
   two samples of one launch of 4 steps from the start state (kernel
   only), beside its bound; (e) the column-tile kernel's two modes at an
   odd depth and at the verify recipe's nz=150 (nz=7 x 1,001 and nz=150 x
   333 columns, each with a ragged last tile), under SSPRK33 and SSPRK104,
   f64 and f32, against the plain version as in (c);
21. per-column BC kinds and geometry under the implicit steppers with a MOST
   top (kernel modes B4+B5 with B1-batched and B8:
   ``csrc/implicit_most_columns_kernel.cu``; ROADMAP B item 2, MOST
   remainder): (a) 17d's cold MOST column at nz=64 x 65,536 with per-column
   kinds at its bottom faces and depths 0.8-1.2 of 2 m, one launch of 8
   steps of 60 s, f64 and f32, in ``B4-trbdf2+B3-rate+B5+kinds+B8+B7``
   (step-indexed theta_atm rows, through ``make_forced_segment_run(engine=
   "fused")``) and ``B4-trbdf2+B2+B3-eq+B5+kinds+B8`` (through
   ``Simulation(engine="fused")``), each equal bit for bit to the script's
   own launch, held to the plain version by a launch of its first 2 steps,
   ice formed, then timed from the start state beside 17d's
   instance on it (the cost of ``MODE_COLUMNS`` under MOST); (b) the flagship run file's soil alone on a
   variable-depth regolith with a batched bottom at nz=24 x 131,072 as a run
   file (TRBDF2Soil, ``"iters": 2``, ``"engine": "pallas"``, dt 60 s, f64)
   through ``python -m landhydrology_tpu_torch run``
   (``B4-trbdf2+B5+kinds+B8``, 2 launches of 8 steps), its first save equal
   bit for bit to the file's first launch in this process, that launch on
   every 64th column against the plain version; (c) the 12 implicit no-ice
   instances with ``MODE_COLUMNS`` (the plain soil's and the MOST top's) on
   the icy state, f64, one well-conditioned step of 5 s, then each of the
   24 new instances on 1,000 cold columns with kinds and depths, 2 steps of
   60 s, a third with forcing rows, two also with PCR, f64 and f32, against
   the plain version; (d) each timed at 17e's width (nz=64 x 65,536, two
   samples of one launch of 4 steps from the start state, kernel only),
   beside its bound;
6. times of every mode's kernel and plain version at its phase-4/5/8/9/10/12/14
   shape (CUDA events: the kernel x3 twice, then the plain version once,
   warm),
   beside the least time the card could take (with the MOST solve's probes
   counted from the plain version's solves on the same inputs, under a
   counting shim that is not timed), and the scratch traffic per cell and
   step of the implicit kernel.  Phase 12 also times one launch of each of
   its ``MODE_COLUMNS`` variants but B1 at nz=48 x 32,768 (the plain version
   not timed), and phases 11 and 13 time their plain versions once.

``--forced-only`` runs phases 1, 2 and 11 alone (a quick check of kernel
B7), ``--grid-only`` phases 1, 2 and 12 with phase 6's times of phase 12's
paths, ``--adaptive-only`` phases 1, 2 and 13, ``--grad-only`` phases 1, 2
and 14 (14b times its policy paths), ``--cli-only`` phases 1, 2 and 15
(``--seed`` seeds 15b's Ksat), ``--land-only`` phases 1, 2, 10 and 16 with
phase 6's times of phase 10's paths, ``--cold-forced-only`` phases 1, 2 and
17 with phase 6's times of 17d's paths, ``--land-rk-only`` phases 1, 2 and 18
with phase 6's times of 18a's paths, ``--land-columns-only`` phases 1, 2 and
19, ``--soil-columns-only`` phases 1, 2 and 20, ``--most-columns-only``
phases 1, 2 and 21.  ``--compare-with PARENT``
builds this tree
and the tree at PARENT (an unpacked ``git archive`` of another commit) in
turns in subprocesses and holds the other tree's instances to their
registers (but those of ``REPAIRED``, and the instances of ``REDESIGNED``
that the column-tile kernel replaced; it prints the new ``MODE_COLUMNS``
instances' registers and spill stores beside their twins' without it) and
the
kernel times of B1 and of ``COMPARE_LAND``'s SSPRK33 land instances to
within 2% of the other's, and times the column-tile kernel's modes at the
regional hour's shape in both trees (``COMPARE_TILE``), each faster than
the other tree's instance.  With ``--profile`` a seventh phase follows for B1 and B2 at the phase-4
shape: six timings each of the kernel and the plain version in turns, a
``tile_cols`` sweep, the SM clock and power draw under load, and
``Simulation.run`` end to end, unprofiled and under ``torch.profiler``
(device busy time, its share of the wall time, the kernel's share of both).

Exits non-zero on any failure, and without a result when no GPU is present.
The line before the last three is the whole run's time, the line before
the last two the ``{"kernels": [...]}`` record, then the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import math
import re
import shutil
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NZ, NCOL, N_STEPS, SPC, DT = 64, 65536, 96, 32, 1.0
FREEZE_STEPS, FREEZE_DT = 64, 5.0  # the freeze golden's run, in two launches
STIFF_FACTOR, STIFF_STEPS = 40, 8  # bench.py's --implicit-dt-factor and spc_im
#: the TPU kernel every mode replaces: pl.pallas_call of _run
REPLACES = "landhydrology_tpu/ops/pallas/column_kernel.py:624"
#: H100 SXM data sheet: HBM3 bytes/s, and FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def _load_golden_config():
    spec = importlib.util.spec_from_file_location(
        "golden_config_torch", os.path.join(HERE, "tests", "data", "golden_config_torch.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_bench_model(nz, ncol, dtype, device):
    """The benchmark configuration of ``bench.py::build`` (coupled column,
    zero-flux top, free drainage, laterally varying moisture and
    temperature), built with the port's API."""
    from landhydrology_tpu_torch import (
        Column, FreeDrainage, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
        SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux, initialize_states,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import (
        k_solid, ksat_frozen, ksat_unfrozen, volumetric_heat_capacity,
        volumetric_internal_energy,
    )

    nu = 0.5
    ks = k_solid(0.0, 0.92, 7.7, 2.5, 0.25)
    msp = SoilParams(
        nu=nu, S_s=1e-3, nu_ss_quartz=0.92, rho_c_ds=(1 - nu) * 1.926e6,
        kappa_solid=ks, kappa_sat_unfrozen=ksat_unfrozen(ks, nu, 0.57),
        kappa_sat_frozen=ksat_frozen(ks, nu, 2.29),
    )
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=2.0, alpha=2.6, Ksat=0.0443 / 3600 / 100, theta_r=0.0
            )
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=FreeDrainage(), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=msp, dtype=dtype, device=device,
    )

    def ic(z, m):
        col = torch.arange(ncol, dtype=dtype, device=device)[None, :] / ncol
        theta = (0.25 + 0.2 * col + 0.0 * z).expand(nz, ncol)
        theta_i = torch.zeros((nz, ncol), dtype=dtype, device=device)
        T = 284.0 + 6.0 * col + 2.0 * z
        rho_c_s = volumetric_heat_capacity(theta, theta_i, msp.rho_c_ds, ps)
        return {
            "vartheta_l": theta,
            "theta_i": theta_i,
            "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps),
        }

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya


def build_variant_model(ncol, dtype, device, seed):
    """A heterogeneous coupled column with Dirichlet, flux and callable BC
    values at both faces, temperature-dependent viscosity, ice impedance
    and some ice: the kernel paths the benchmark configuration leaves out."""
    from landhydrology_tpu_torch import (
        Column, Dirichlet, SoilColumnBC, SoilComponentBC, SoilHydrologyModel,
        SoilModel, SoilParams, VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import (
        IceImpedance, TemperatureDependentViscosity, vanGenuchten,
    )
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity, volumetric_internal_energy,
    )

    rng = np.random.default_rng(seed)

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    nz = 16
    model = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(
                n=tensor(rng.uniform(1.5, 3.5, ncol)),
                alpha=tensor(rng.uniform(1.5, 4.0, ncol)),
                Ksat=tensor(rng.uniform(1e-7, 1e-5, ncol)),
                theta_r=tensor(rng.uniform(0.0, 0.05, ncol)),
            ),
            viscosity_factor=TemperatureDependentViscosity(),
            impedance_factor=IceImpedance(),
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(
                hydrology=Dirichlet(lambda t: 0.4 + 1e-4 * t),
                energy=VerticalFlux(tensor(rng.uniform(-5.0, 5.0, ncol))),
            ),
            bottom=SoilComponentBC(
                hydrology=Dirichlet(0.38), energy=Dirichlet(lambda t: 283.0 + 0.0 * t)
            ),
        ),
        soil_param_set=SoilParams(nu=tensor(rng.uniform(0.45, 0.55, ncol)), rho_c_ds=0.963e6),
        dtype=dtype, device=device,
    )
    theta = tensor(0.3 + 0.1 * rng.random((nz, ncol)))
    theta_i = tensor(0.03 * rng.random((nz, ncol)))
    T = tensor(285.0 + 5.0 * rng.random((nz, ncol)))
    rho_c_s = volumetric_heat_capacity(theta, theta_i, 0.963e6, ps)
    Y = {"soil": {
        "vartheta_l": theta, "theta_i": theta_i,
        "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps),
    }}
    return model, Y


def icy_state(model, Y):
    """``Y`` with theta_i 0.05 and vartheta_l = nu - 0.02 in the lower half
    of the column (rho_e_int as it was): vartheta_l > nu - theta_i there,
    where the cap of theta_l under ``assume_no_ice`` at nu and the rhs's
    cap at nu - theta_i part (ROADMAP C)."""
    soil = {k: v.clone() for k, v in Y["soil"].items()}
    lower = slice(0, soil["vartheta_l"].shape[0] // 2)
    nu = torch.as_tensor(model.soil_param_set.nu, dtype=soil["vartheta_l"].dtype, device=soil["vartheta_l"].device)
    soil["theta_i"][lower] = 0.05
    soil["vartheta_l"][lower] = (nu - 0.02).expand_as(soil["vartheta_l"][lower])
    return {"soil": soil}


def branch_variants(dtype, device, ncol=1000):
    """``(model, state, stepper, dt, steps, what, moving fields)`` of phase
    3's water-only and heat-only variants on ``ncol`` columns: SSPRK33 and
    TR-BDF2 on each branch."""
    from landhydrology_tpu_torch import (
        Dirichlet, FreeDrainage, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC,
    )
    from landhydrology_tpu_torch.models.soil import TemperatureDependentViscosity
    from landhydrology_tpu_torch.timestepping import SSPRK33

    stiff, Y, _ = build_stiff(16, ncol, dtype, device)
    water = dataclasses.replace(
        stiff,
        energy_model=PrescribedTemperatureModel(T_profile=lambda z, t: 285.0 + 3.0 * z + 1e-3 * t),
        hydrology_model=dataclasses.replace(stiff.hydrology_model,
                                            viscosity_factor=TemperatureDependentViscosity()),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.25 + 1e-3 * t)),
                                         bottom=SoilComponentBC(hydrology=FreeDrainage())),
    )
    heat, Yh, _ = build_heat_only(16, ncol, dtype, device, seed=3)
    return (
        (water, Y, SSPRK33(), 0.05, 10, "callable Dirichlet top, T profile, viscosity", ("vartheta_l",)),
        (stiff, Y, implicit("TRBDF2Soil", stiff, 2), 5.0, 4, "stiff infiltration, callable Dirichlet top",
         ("vartheta_l",)),
        (heat, Yh, SSPRK33(), 10.0, 10, "callable Dirichlet top, per-column flux, profiles", ("rho_e_int",)),
        (heat, Yh, implicit("TRBDF2Soil", heat, 2), 600.0, 4,
         "callable Dirichlet top, per-column flux, profiles", ("rho_e_int",)),
    )


def build_freeze_wide(gc, dtype, device, freeze_thaw, ncol=None):
    """The freeze golden's column (``golden_config_torch.build_freeze_model_and_state``)
    at the main path's width, nz=64 x 65,536 (or ``ncol`` columns), with
    initial water content 0.22-0.34 and temperature 273.4-275.4 K varied by
    column under the -10 C surface."""
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity, volumetric_internal_energy,
    )

    ncol = NCOL if ncol is None else ncol
    model, _, Ya, dt = gc.build_freeze_model_and_state(
        dtype, device, nz=NZ, ncol=ncol, freeze_thaw=freeze_thaw
    )
    col = torch.arange(ncol, dtype=dtype, device=device)[None, :] / ncol
    theta = (0.22 + 0.12 * col).expand(NZ, ncol).contiguous()
    theta_i = torch.zeros_like(theta)
    T = (273.4 + 2.0 * col).expand(NZ, ncol)
    rho_c_s = volumetric_heat_capacity(theta, theta_i, model.soil_param_set.rho_c_ds, ps)
    Y = {"soil": {
        "vartheta_l": theta, "theta_i": theta_i,
        "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps).contiguous(),
    }}
    return model, Y, Ya, dt


def build_stiff(nz, ncol, dtype, device):
    """``bench.py::build_stiff``, built with the port's API: the stiff sand
    infiltration (``richards_equation.jl:98-190``), water-only, a callable
    Dirichlet top at 0.267 and free drainage below, initial moisture
    0.10-0.12 varied by column."""
    from landhydrology_tpu_torch import (
        Column, Dirichlet, FreeDrainage, PrescribedTemperatureModel, SoilColumnBC,
        SoilComponentBC, SoilHydrologyModel, SoilModel, SoilParams, initialize_states,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten

    model = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(
            hydraulic_model=vanGenuchten(n=3.96, alpha=2.7, Ksat=34.0 / 3600.0 / 100.0, theta_r=0.075)
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.267)),
            bottom=SoilComponentBC(hydrology=FreeDrainage()),
        ),
        soil_param_set=SoilParams(nu=0.287, S_s=1e-3),
        dtype=dtype, device=device,
    )

    def ic(z, m):
        col = torch.arange(ncol, dtype=dtype, device=device)[None, :] / ncol
        theta = 0.10 + 0.02 * col + 0.0 * z
        return {"vartheta_l": theta.expand(nz, ncol), "theta_i": torch.zeros((nz, ncol), dtype=dtype, device=device)}

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya


def stiff_dt_explicit(model, Y):
    """``dt_exp`` of bench.py's implicit path: half the explicit limit at
    the sharpest state the run can visit, the dry initial value 0.1 and the
    Dirichlet value 0.267 on alternating cells."""
    from landhydrology_tpu_torch.diagnostics import explicit_dt_limit

    v = Y["soil"]["vartheta_l"]
    levels = torch.arange(v.shape[0], device=v.device)[:, None] % 2 == 0
    dry, wet = (torch.tensor(x, dtype=v.dtype, device=v.device) for x in (0.1, 0.267))
    front = torch.where(levels, dry, wet).expand(v.shape)
    return 0.5 * float(explicit_dt_limit(model, {"soil": dict(Y["soil"], vartheta_l=front)}))


def build_heat_only(nz, ncol, dtype, device, seed=None):
    """A heat-only column (PrescribedHydrologyModel, the branch of
    ``tests/soil/test_heat.py``): the benchmark configuration's soil with
    prescribed moisture 0.25 + 0.05 z (+ 1e-6 t) and a little ice, a
    callable Dirichlet top at 281 K and a zero-flux bottom (with ``seed``: a
    per-column flux); temperature 284-290 K varied by column."""
    from landhydrology_tpu_torch import (
        Dirichlet, PrescribedHydrologyModel, SoilColumnBC, SoilComponentBC, VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity, volumetric_internal_energy,
    )

    model, _, _ = build_bench_model(nz, ncol, dtype, device)
    flux = 0.0
    if seed is not None:
        flux = torch.as_tensor(np.random.default_rng(seed).uniform(-5.0, 5.0, ncol), dtype=dtype, device=device)
    model = dataclasses.replace(
        model,
        hydrology_model=PrescribedHydrologyModel(
            vartheta_l_profile=lambda z, t: 0.25 + 0.05 * z + 1e-6 * t,
            theta_i_profile=lambda z, t: 0.01 + 0.0 * z,
        ),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(energy=Dirichlet(lambda t: 281.0 + 0.0 * t)),
            bottom=SoilComponentBC(energy=VerticalFlux(flux)),
        ),
    )
    from landhydrology_tpu_torch.domains import make_function_space

    z = make_function_space(model.domain, dtype, device).zc
    col = torch.arange(ncol, dtype=dtype, device=device)[None, :] / ncol
    T = (284.0 + 6.0 * col + 2.0 * z).expand(nz, ncol)
    theta, theta_i = (0.25 + 0.05 * z).expand(nz, ncol), torch.full((nz, ncol), 0.01, dtype=dtype, device=device)
    rho_c_s = volumetric_heat_capacity(theta, theta_i, model.soil_param_set.rho_c_ds, ps)
    Y = {"soil": {"rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps).contiguous()}}
    return model, Y, {"zc": z, "soil": {}}


def build_kernel_test_model(top, bottom, nz, ncol, dtype, device, seed=0, heterogeneous=False):
    """The coupled column of the JAX package's fused-kernel tests
    (``tests/test_pallas_kernel.py::_model/_state``): the benchmark soil with
    the given hydrology BCs, zero-flux energy faces and random moisture and
    temperature; with ``heterogeneous`` per-column van Genuchten parameters
    and porosity (``:476-519``)."""
    from landhydrology_tpu_torch import SoilColumnBC, SoilComponentBC, VerticalFlux
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import (
        volumetric_heat_capacity, volumetric_internal_energy,
    )

    model, _, _ = build_bench_model(nz, ncol, dtype, device)
    model = dataclasses.replace(model, boundary_conditions=SoilColumnBC(
        top=SoilComponentBC(hydrology=top, energy=VerticalFlux(0.0)),
        bottom=SoilComponentBC(hydrology=bottom, energy=VerticalFlux(0.0)),
    ))
    rng = np.random.default_rng(seed)

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    if heterogeneous:
        hm = vanGenuchten(n=tensor(rng.uniform(1.8, 3.0, ncol)), alpha=tensor(rng.uniform(1.5, 4.0, ncol)),
                          Ksat=tensor(rng.uniform(1e-7, 1e-5, ncol)), theta_r=tensor(rng.uniform(0.0, 0.05, ncol)))
        model = dataclasses.replace(
            model,
            hydrology_model=dataclasses.replace(model.hydrology_model, hydraulic_model=hm),
            soil_param_set=dataclasses.replace(model.soil_param_set, nu=tensor(rng.uniform(0.45, 0.55, ncol))),
        )
    theta = tensor(0.3 + 0.1 * rng.random((nz, ncol)))
    theta_i = torch.zeros_like(theta)
    T = tensor(285.0 + 5.0 * rng.random((nz, ncol)))
    rho_c_s = volumetric_heat_capacity(theta, theta_i, model.soil_param_set.rho_c_ds, ps)
    return model, {"soil": {"vartheta_l": theta, "theta_i": theta_i,
                            "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps)}}


def build_land_model(nz, ncol, dtype, device, surface_update="stage", coefficient_update="stage"):
    """``bench.py::build_land``, built with the port's API: the benchmark
    column under a MOST atmosphere (2 m/s, 297 K at 2 m, q 0.005), a rain
    pulse of 8e-6 m/s that lasts the run and a pond of 1e-4 m (tau_pond 300
    s), zero-flux bottom; ``surface_update="step"`` with
    ``coefficient_update="step"`` is bench.py's production setting."""
    from landhydrology_tpu_torch import PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC, VerticalFlux
    from landhydrology_tpu_torch.models.land import LandModel, PulsePrecipitation, SurfaceWaterModel

    model, Y, Ya = build_bench_model(nz, ncol, dtype, device)
    soil = dataclasses.replace(
        model, assume_no_ice=False, coefficient_update=coefficient_update,
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0,
                                       rho_a_sfc=1.2, q_atm=0.005),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
    )
    land = LandModel(
        soil=soil,
        surface=SurfaceWaterModel(precipitation=PulsePrecipitation(rate=8e-6, t_start=0.0, t_stop=1e9),
                                  tau_pond=300.0),
        surface_update=surface_update,
    )
    Y = dict(Y, surface={"h_s": torch.full((ncol,), 1e-4, dtype=dtype, device=device)})
    return land, Y, Ya


def build_pallas_land(dtype, device, surface_update="stage"):
    """The LandModel of the JAX package's fused test
    (``tests/test_pallas_kernel.py:278``): its soil column (nz=16 x 256)
    under a MOST atmosphere (2 m/s, 300 K), 6e-6 m/s of rain until t = 40,
    tau_pond 120 s, columns 0.18-0.23 wet and 290-292 K, no pond."""
    from landhydrology_tpu_torch import PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC, VerticalFlux
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.land import LandModel, PulsePrecipitation, SurfaceWaterModel
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy

    nz, ncol = 16, 256
    base, _ = build_kernel_test_model(VerticalFlux(0.0), VerticalFlux(0.0), nz, ncol, dtype, device)
    soil = dataclasses.replace(base, boundary_conditions=SoilColumnBC(
        top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                                   rho_a_sfc=1.2, q_atm=0.005),
        bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
    ))
    land = LandModel(soil=soil, surface=SurfaceWaterModel(
        precipitation=PulsePrecipitation(rate=6e-6, t_start=0.0, t_stop=40.0), tau_pond=120.0,
        h_evap_smoothing=1e-4), surface_update=surface_update)
    col = torch.linspace(0.0, 1.0, ncol, dtype=dtype, device=device)[None, :]
    theta = (0.18 + 0.05 * col).expand(nz, ncol).contiguous()
    theta_i = torch.zeros_like(theta)
    T = (290.0 + 2.0 * col).expand(nz, ncol)
    rho_c_s = volumetric_heat_capacity(theta, theta_i, soil.soil_param_set.rho_c_ds, ps)
    Y = {"soil": {"vartheta_l": theta, "theta_i": theta_i,
                  "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps).contiguous()},
         "surface": {"h_s": torch.zeros(ncol, dtype=dtype, device=device)}}
    return land, Y


def build_step_land(dtype, device, surface_update="step"):
    """The LandModel of ``tests/test_land_model.py:862``: nz=16 x 64, the
    golden land soil (vanGenuchten(2.0, 2.6, 2e-7, 0.05), nu 0.4), MOST
    atmosphere 2 m/s / 300 K, 8e-6 m/s of rain until t = 60, tau_pond 120 s,
    moisture 0.15-0.25 by column at 291 K, no pond."""
    from landhydrology_tpu_torch import (
        Column, PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
        SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.land import LandModel, PulsePrecipitation, SurfaceWaterModel
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy

    nz, ncol = 16, 64
    soil = SoilModel(
        domain=Column(zlim=(-1.5, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7, theta_r=0.05)),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0,
                                       rho_a_sfc=1.2, q_atm=0.005),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6), dtype=dtype, device=device,
    )
    land = LandModel(soil=soil, surface=SurfaceWaterModel(
        precipitation=PulsePrecipitation(rate=8e-6, t_start=0.0, t_stop=60.0), tau_pond=120.0),
        surface_update=surface_update)
    theta = (0.15 + 0.1 * torch.linspace(0.0, 1.0, ncol, dtype=dtype, device=device)[None, :]).expand(nz, ncol)
    theta_i = torch.zeros((nz, ncol), dtype=dtype, device=device)
    rho_c_s = volumetric_heat_capacity(theta, theta_i, 1.3e6, ps)
    T = torch.full((nz, ncol), 291.0, dtype=dtype, device=device)
    Y = {"soil": {"vartheta_l": theta.contiguous(), "theta_i": theta_i,
                  "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps).contiguous()},
         "surface": {"h_s": torch.zeros(ncol, dtype=dtype, device=device)}}
    return land, Y


def cold_policy(case):
    """``(case without its step policy, the soil's options)``: a name that
    ends in ``+B3-rate`` (``FreezeThaw(tau=60)``), ``+B3-eq``
    (``EquilibriumFreezeThaw()``) or ``-no-ice`` (``assume_no_ice``)."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw

    for suffix, options in (("+B3-rate", {"freeze_thaw": FreezeThaw(tau=60.0)}),
                            ("+B3-eq", {"freeze_thaw": EquilibriumFreezeThaw()}),
                            ("-no-ice", {"assume_no_ice": True})):
        if case.endswith(suffix):
            return case[: -len(suffix)], options
    return case, {}


def build_land_variant(ncol, dtype, device, seed, case, cold=False):
    """The JAX fused test's soil (nz=16) under per-column atmosphere fields:
    wind 0.3-5 m/s, theta_atm within 8 K of each column's surface
    temperature (both Businger branches and the decoupling edge), q_atm
    0.002-0.012, and a callable theta_scale; a pond of 0-2e-4 m.  ``case``
    is the mode to build: ``B5``, ``B2+B5``, a B6 name (``B6``, ``B6-step``,
    ``B2+B6``, ``B2+B6-step``), or one of those with ``-pond`` (the soil's
    zero-flux top), each with a step policy (``cold_policy``) or none.
    ``cold``: the columns at 268-278 K (by column, and up to 0.5 K more by
    level) with 0.02 of ice in every cell, so the columns below T_0 freeze
    and those above it thaw."""
    from landhydrology_tpu_torch import PrescribedAtmosForcing, SoilColumnBC, VerticalFlux
    from landhydrology_tpu_torch.models.land import LandModel, PulsePrecipitation, SurfaceWaterModel
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy

    case, policy = cold_policy(case)
    rng = np.random.default_rng(seed)
    tensor = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    base, Y = build_kernel_test_model(VerticalFlux(0.0), VerticalFlux(0.0), 16, ncol, dtype, device, seed=seed)
    ps = base.earth_param_set
    if cold:
        col = torch.linspace(0.0, 1.0, ncol, dtype=dtype, device=device)[None, :]
        T = 268.0 + 10.0 * col + tensor(0.5 * rng.random((16, ncol)))
        theta, theta_i = Y["soil"]["vartheta_l"], torch.full((16, ncol), 0.02, dtype=dtype, device=device)
        rho_c_s = volumetric_heat_capacity(theta, theta_i, base.soil_param_set.rho_c_ds, ps)
        Y = {"soil": {"vartheta_l": theta, "theta_i": theta_i,
                      "rho_e_int": volumetric_internal_energy(theta_i, rho_c_s, T, ps)}}
        T_top = T[-1]
    else:
        v, ti = Y["soil"]["vartheta_l"][-1], Y["soil"]["theta_i"][-1]
        rho_c_s = base.soil_param_set.rho_c_ds + torch.minimum(v, base.soil_param_set.nu - ti) * ps.rho_cp_l
        T_top = ps.T_0 + Y["soil"]["rho_e_int"][-1] / rho_c_s
    atmos = PrescribedAtmosForcing(
        u_atm=tensor(rng.uniform(0.3, 5.0, ncol)), theta_atm=T_top + tensor(rng.uniform(-8.0, 8.0, ncol)),
        z_atm=2.0, theta_scale=lambda t: 290.0 + 1e-3 * t, rho_a_sfc=1.2,
        q_atm=tensor(rng.uniform(0.002, 0.012, ncol)),
    )
    lagged = "step" if case.startswith("B2") else "stage"
    soil = dataclasses.replace(base, coefficient_update=lagged, boundary_conditions=SoilColumnBC(
        top=atmos, bottom=base.boundary_conditions.bottom), **policy)
    if case in ("B5", "B2+B5"):
        return soil, Y
    if case.endswith("-pond"):
        soil = dataclasses.replace(soil, boundary_conditions=base.boundary_conditions)
    land = LandModel(soil=soil, surface=SurfaceWaterModel(
        precipitation=PulsePrecipitation(rate=5e-6, t_start=0.0, t_stop=12.0), tau_pond=120.0),
        surface_update="step" if "step" in case else "stage")
    return land, dict(Y, surface={"h_s": tensor(rng.uniform(0.0, 2e-4, ncol))})


def implicit(name, model, iters=2, tridiag="thomas"):
    """The port's implicit stepper ``name`` for ``model``, on its grid."""
    from landhydrology_tpu_torch import imex
    from landhydrology_tpu_torch.domains import make_function_space

    grid = make_function_space(model.domain, model.float_dtype, model.device)
    return getattr(imex, name)(model=model, grid=grid, iters=iters, tridiag=tridiag)


# ---- the least time the card could take ----

#: small kernels whose SASS gives the cost of one call of each operation
_OP_SOURCE = "\n".join(
    f'extern "C" __global__ void op_{name}_{tag}(const {T}* x, const {T}* y, {T}* o) '
    f"{{ int i = threadIdx.x; o[i] = {expr}; }}"
    for tag, T, sfx in (("f32", "float", "f"), ("f64", "double", ""))
    for name, expr in (("copy", "x[i]"), ("exp", f"exp{sfx}(x[i])"), ("log", f"log{sfx}(x[i])"),
                       ("sqrt", f"sqrt{sfx}(x[i])"), ("div", "x[i] / y[i]"))
)
#: floating-point instructions of each type's own pipe in SASS
_FP_OPCODES = {
    torch.float32: {"FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FCHK", "FRND", "MUFU"},
    torch.float64: {"DFMA", "DADD", "DMUL", "DSETP", "DMNMX"},
}
_SASS_OPCODE = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def _cuobjdump(nvcc):
    for path in (os.path.join(os.path.dirname(nvcc), "cuobjdump"), shutil.which("cuobjdump")):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("cuobjdump not found beside nvcc or on PATH")


def op_costs(ck):
    """``{dtype: {op: instructions}}``: the floating-point instructions of
    one exp, log, sqrt and division, from ``cuobjdump -sass`` of
    ``_OP_SOURCE`` built as the kernel is, counted up to the first EXIT (the
    fast path: the rare slow paths are left out) less the copy kernel's."""
    ck.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, cubin = ck.BUILD_DIR / "op_costs.cu", ck.BUILD_DIR / "op_costs.cubin"
    src.write_text(_OP_SOURCE + "\n")
    nvcc = ck._nvcc()
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(cubin), str(src)], check=True, capture_output=True)
    sass = subprocess.run([_cuobjdump(nvcc), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        dtype = torch.float32 if name.endswith("f32") else torch.float64
        n = 0
        for line in block.splitlines()[1:]:
            m = _SASS_OPCODE.match(line)
            if not m:
                continue
            if m.group(1) == "EXIT":
                break
            n += m.group(1) in _FP_OPCODES[dtype]
        counts[name] = n
    costs = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        base = counts[f"op_copy_{tag}"]
        costs[dtype] = {op: counts[f"op_{op}_{tag}"] - base for op in ("exp", "log", "sqrt", "div")}
        # pow(x, y) is at least exp(y log x)
        costs[dtype]["pow"] = costs[dtype]["exp"] + costs[dtype]["log"]
    return costs


def _instance(ck, line):
    """``(mangled entry, instance name)`` of a ptxas line that starts
    compiling a kernel's template instance, else ``None``: the float type
    and the mode's name (the instances that read the stage table, which run
    every explicit stepper, by the mode alone after "rk:", "tile:" for the
    column-tile kernel and, for the land kernel, "table:")."""
    m = re.search(r"Compiling entry function '(\w*?(ssprk33|implicit|land|rk|tile)_column_kernelI([fd])Li(\d+)E(Lb1E)?\w*)'",
                  line)
    if not m:
        return None
    kind = {"rk": "rk:", "tile": "tile:"}.get(m.group(2), "table:" if m.group(5) else "")
    return m.group(1), f"{'f32' if m.group(3) == 'f' else 'f64'}, {kind}{ck.mode_name(int(m.group(4)) & ~ck.MODE_RHS_CAP)}"


def registers(ck, libs):
    """``{kernel name: registers per thread}`` of each template instance of
    the kernels, from the ptxas reports the build keeps beside the
    libraries."""
    out = {}
    for lib in libs.values():
        name = None
        for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
            name = (_instance(ck, line) or (None, name))[1]
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name], name = int(m.group(1)), None
    return out


def spill_stores(ck, libs):
    """``{kernel name: bytes of spill stores}`` of each template instance,
    from the line of ptxas' report that follows its "Function properties"
    (a device function's own properties are not the kernel's)."""
    out = {}
    for lib in libs.values():
        entry = name = props = None
        for line in lib.with_suffix(".ptxas.txt").read_text().splitlines():
            entry, name = _instance(ck, line) or (entry, name)
            m = re.search(r"Function properties for (\w+)", line)
            if m:
                props = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name and props == entry:
                out[name], props = int(m.group(1)), None
    return out


#: operations per cell of the pieces the modes are made of, counted from
#: csrc/column_common.cuh and the kernel sources (a multiply-add counts
#: once); the data-dependent parts (the frozen Kersten branch, the
#: conductivity factors, the boundary faces) are left out
_HYDRAULIC = dict(op=22, div=2, exp=2, log=2, sqrt=1)  # conductivity()
_THERMAL = dict(op=29, div=4, exp=3, log=2)  # T, rho_c_s, thermal_conductivity()
_PSI = dict(op=13, div=2, exp=2, log=2)  # pressure_head()
_TEMP = dict(op=5, div=1)  # rho_c_s and T of the coupled state (in _THERMAL)
_DPSI = dict(op=25, div=2, exp=2, log=2)  # dpsi_dtheta()


def stage_combinations(ck, mode):
    """Operations per value and step of an explicit stepper's stage
    combinations (``column_common.cuh::stage_value``; a multiply-add counts
    once): ForwardEuler 1, SSPRK22 4, SSPRK33 6, SSPRK104 16 (an axpy 1, a
    combination 3, SSPRK104's split 4 and last stage 3)."""
    return {ck.MODE_EULER: 1, ck.MODE_SSPRK22: 4, ck.MODE_SSPRK104: 16}.get(mode & ck.MODE_RK, 6)


def cell_step_ops(ck, mode, n_iter=60, iters=2, nz=NZ):
    """Operations per cell and step of one mode, counted from the sources:
    calls of exp, log, pow, sqrt and divisions by name, and the other
    floating-point operations (``op``; a multiply-add counts once).  Work
    that depends on the data is left out, so the count is a lower bound.
    The implicit modes count their rhs evaluations, the closed-form C of
    each water sweep, and each sweep's assembly and solve (Thomas, or
    ceil(log2 nz) PCR levels).  A water sweep reads only the vartheta_l
    tendency, which needs no kappa: in the coupled branch its rhs counts K
    at the T of the coupled state, and no thermal conductivity or energy
    flux (the kernel computes them there all the same).  The step policies
    of the implicit modes: lagged coefficients count one coefficient pass
    per step, the other rhs evaluations without their closures and the heat
    sweeps' live kappa; rate freeze-thaw the sources of every rhs
    evaluation and of theta_i's fixed points; the equilibrium projection
    its bisection once per step.  The explicit modes count one rhs sweep per
    stage of their stepper (ForwardEuler 1, SSPRK22 2, SSPRK33 3, SSPRK104
    10) and their stage combinations per field (SSPRK33 2 per stage as
    before; ForwardEuler 1, SSPRK22 4, SSPRK104 16 per step: an axpy 1, a
    combination 3, SSPRK104's split 4 and last stage 3); lagged coefficients
    on a branch, K (water-only) or the thermal closures (heat-only) once per
    step and psi or T per stage."""
    no_ice = bool(mode & ck.MODE_NO_ICE)
    water = not mode & ck.MODE_HEAT
    heat = not mode & ck.MODE_WATER
    ops = collections.Counter()

    def add(n, **counts):
        for k, v in counts.items():
            ops[k] += n * v

    closures = (dict(op=36, div=4, exp=4, log=4, sqrt=1) if no_ice  # closures<T, M>
                else dict(op=51, div=6, exp=5, log=4, sqrt=1))

    def rhs(n, water_sweep=False):  # n rhs evaluations of the branch, with the face fluxes
        if water and heat and not water_sweep:
            add(n, **closures)
            add(n, **_PSI)
            add(n, op=6 + 15, div=4)  # nu_eff, theta_l, rho_e_int_l K, h; fluxes, divergence
        elif water:  # the water-only branch, or a water sweep's water tendency
            add(n, **_HYDRAULIC)
            add(n, **_PSI)
            add(n, op=3 + 8, div=2)
            if heat:
                add(n, **_TEMP)
        else:
            add(n, **_THERMAL)
            add(n, op=2 + 7, div=2)

    fields = (2 if water else 0) + (1 if heat else 0)
    implicit = mode & ck.MODE_IMPLICIT
    if not implicit:
        stages = explicit_stages(ck, mode)
        combine = stage_combinations(ck, mode)
        if mode & ck.MODE_LAGGED and water and not heat:  # K once, psi per stage
            add(1, **_HYDRAULIC)
            add(stages, **_PSI)
            add(stages, op=3 + 8, div=2)
            add(1, op=combine * fields)
        elif mode & ck.MODE_LAGGED and heat and not water:  # the thermal closures once, T per stage
            add(1, **_THERMAL)
            add(1, div=1)  # 1 / rho_c_s
            add(stages, op=4 + 7, div=2)
            add(1, op=combine * fields)
        elif mode & ck.MODE_LAGGED:  # coefficients once, then psi and T per stage
            add(1, **closures)
            add(1, op=5, div=1)  # nu_eff, theta_l, 1/rho_c_s, rho_e_int_l K
            add(stages, **_PSI)
            add(stages, op=21, div=4)  # interior face fluxes and the stage update
            add(stages, op=4 if no_ice else 7)  # nu_eff, theta_l, T, h
            add(1, op=(combine - 2 * stages) * fields)  # beyond the update counted with the fluxes
        else:
            rhs(stages)
            add(1, op=combine * fields)  # the stage combinations
        if mode & ck.MODE_FREEZE_RATE:  # phase_change_sources per stage
            add(stages, op=26, div=5, pow=2)
        if mode & ck.MODE_FREEZE_EQ:  # bisection, first residual, last partition
            add(1, op=28 * n_iter + 41, div=n_iter + 2, pow=2 * n_iter + 4)
        return ops
    pcr = bool(mode & ck.MODE_PCR)
    levels = math.ceil(math.log2(nz)) if nz > 1 else 0

    def sweeps(n, water_sweep):
        if water_sweep:
            add(n, **_DPSI)
        else:
            add(n, div=1)  # 1 / rho_c_s
        add(n, op=20)  # the row of I - w A and b
        if pcr:
            add(n, op=12 * levels, div=2 * levels + 1)
        else:
            add(n, op=7, div=1)  # elimination and back substitution
        add(n, op=3 if water_sweep else 1)  # clamp, update

    lagged = bool(mode & ck.MODE_LAGGED)

    def coupled_rhs(n):  # a coupled rhs that is not a water sweep's: lagged, psi and T alone
        if lagged:
            add(n, **_PSI)
            add(n, op=21 + 7, div=4)
        else:
            rhs(n)

    if mode & ck.MODE_TRBDF2:
        coupled_rhs(1)  # f(u^n)
        if water:
            rhs(2 * iters, water_sweep=True)
            sweeps(2 * iters, True)
        if heat:
            coupled_rhs(2 * iters)
            sweeps(2 * iters, False)
        add(1, op=5 * fields)  # c1 = u + w1 f, c2 = a1 u* + a2 u
        evaluations, fixed_points, heat_sweeps = 1 + 4 * iters, 2 * iters, 2 * iters
    else:
        rhs(iters, water_sweep=True)
        sweeps(iters, True)
        evaluations, fixed_points, heat_sweeps = iters, 0, 0
        if mode & ck.MODE_BE_SOIL:
            coupled_rhs(iters)
            sweeps(iters, False)
            evaluations, fixed_points, heat_sweeps = 2 * iters, 1, iters
        elif heat:  # BackwardEulerRichards' explicit update of theta_i, rho_e_int
            coupled_rhs(1)
            evaluations += 1
    if lagged:  # the coefficients once per step; the heat sweeps' kappa stays live
        add(1, **closures)
        add(1, op=5, div=1)
        add(heat_sweeps, **_THERMAL)
    if mode & ck.MODE_FREEZE_RATE:  # the sources in every rhs and in theta_i's fixed points
        add(evaluations + fixed_points, op=26, div=5, pow=2)
    if mode & ck.MODE_FREEZE_EQ:  # the projection after the step
        add(1, op=28 * n_iter + 41, div=n_iter + 2, pow=2 * n_iter + 4)
    return ops


#: operations of one evaluation of the consistency equation h(1/L) of the
#: MOST solve (csrc/surface_fluxes.cuh: psi_m_diff, psi_h_diff, the
#: denominators and h)
_MOST_H = dict(op=78, div=5, log=2, sqrt=8)


def explicit_stages(ck, mode):
    """Stages per step of a mode's explicit stepper: ForwardEuler 1, SSPRK22
    2, SSPRK33 3 (no stepper bit), SSPRK104 10."""
    return {ck.MODE_EULER: 1, ck.MODE_SSPRK22: 2, ck.MODE_SSPRK104: 10}.get(mode & ck.MODE_RK, 3)


def most_exchanges(ck, mode, iters=2):
    """Surface exchanges (MOST solves under a MOST top) per column and step:
    one per rhs evaluation, so one per stage of the explicit stepper (three
    for SSPRK33), one with ``MODE_SURFACE_STEP``; under the implicit steppers (B4+B5) f(u^n) and a
    water and a heat sweep per iteration of each TR-BDF2 stage (1 + 4
    iters), ``iters`` water and ``iters`` heat sweeps (BackwardEulerSoil)
    or ``iters`` water sweeps and the explicit update
    (BackwardEulerRichards)."""
    if mode & ck.MODE_TRBDF2:
        return 1 + 4 * iters
    if mode & ck.MODE_BE_SOIL:
        return 2 * iters
    if mode & ck.MODE_BE_RICHARDS:
        return iters + 1
    return 1 if mode & ck.MODE_SURFACE_STEP else explicit_stages(ck, mode)


def plain_solves(ck, mode, iters=2):
    """MOST solves per column and step of the plain version: the kernel's
    (``most_exchanges``), and under freeze-thaw the rhs evaluations the eager
    implicit steppers take for theta_i's phase change, which the kernel
    computes without the top face: TR-BDF2 one per iteration of each stage
    under rate freeze-thaw, BackwardEulerSoil one per step under either
    scheme."""
    solves = most_exchanges(ck, mode, iters)
    if mode & ck.MODE_TRBDF2 and mode & ck.MODE_FREEZE_RATE:
        solves += 2 * iters
    if mode & ck.MODE_BE_SOIL and mode & (ck.MODE_FREEZE_RATE | ck.MODE_FREEZE_EQ):
        solves += 1
    return solves


def column_step_ops(ck, mode, dtype, probes=None, iters=2):
    """Operations per column and step of the surface exchange of a B5/B6
    mode, counted from ``csrc/surface_fluxes.cuh``, ``csrc/land_kernel.cu``
    and ``csrc/implicit_kernel.cu`` (an empty count for other modes): per
    exchange (``most_exchanges``) the MOST solve, with
    ``probes`` evaluations of h in its rounds (20 rounds in float64, 4 in
    float32, each stopping at its first probe past the sign change: the
    mean per solve and column of this run's data, ``most_probes``), its
    set-up, the end evaluations (and in float32 the polish) and the finish,
    the humidity, the fluxes, and for B6 the potential infiltration (K and
    psi at the face, psi and T at the center) and the pond's tendency per
    stage and its stage combinations (``stage_combinations``)."""
    ops = collections.Counter()
    if not mode & (ck.MODE_MOST | ck.MODE_LAND):
        return ops
    if mode & ck.MODE_MOST and probes is None:
        raise ValueError("a MOST mode's count needs the probes its solves evaluate")

    def add(n, **counts):
        for k, v in counts.items():
            ops[k] += n * v

    exchanges = most_exchanges(ck, mode, iters)
    if mode & ck.MODE_MOST:
        h_evals = probes + (3 if dtype == torch.float64 else 4)
        add(exchanges * (h_evals + 1), **_MOST_H)  # + the finish's denominators
        add(exchanges, op=3 * h_evals + 20 + 8 * (20 if dtype == torch.float64 else 4), div=5, log=2)
        add(exchanges, op=25, div=6, exp=4, log=2, pow=1)  # q_sat, psi of the surface, q_soil
        blended = bool(mode & ck.MODE_LAND)
        add(exchanges * (2 if blended else 1), op=15, div=1)  # _assemble_fluxes
        if blended:
            add(exchanges, op=10, div=2)  # w, q_eff, r_s, the split
    if mode & ck.MODE_LAND:
        add(exchanges, **_HYDRAULIC)
        add(exchanges * 2, **_PSI)
        if not mode & ck.MODE_WATER:  # the water-only exchange takes 288 K
            add(exchanges, **_TEMP)
        add(exchanges, op=12, div=2)  # f_pot, the supply, the infiltration
        add(explicit_stages(ck, mode), op=2)  # the pond's tendency per stage
        add(1, op=stage_combinations(ck, mode))  # and its stage combinations
    elif not mode & ck.MODE_LAGGED:
        add(exchanges, **_TEMP)
    return ops


def state_fields(ck, mode):
    """Prognostic fields of the mode's branch: 3 coupled, 2 water-only
    (vartheta_l, theta_i), 1 heat-only."""
    return 1 if mode & ck.MODE_HEAT else 2 if mode & ck.MODE_WATER else 3


def scratch_values_per_cell_step(ck, mode, iters=2):
    """Global-memory accesses (loads plus stores) per cell and step that the
    implicit kernel's design moves through its scratch and state, counted
    from ``csrc/implicit_kernel.cu``: per Newton sweep the rhs pass (state
    in, F, K, C out), the assembly (K and C at three levels, F, c, u in; cp,
    dp out, or PCR's four fields and ceil(log2 nz) passes of twelve loads
    and four stores), the back substitution (cp, dp, u in; u out)."""
    water = not mode & ck.MODE_HEAT
    heat = not mode & ck.MODE_WATER
    fields = state_fields(ck, mode)
    levels = math.ceil(math.log2(NZ))

    def sweep(reads_state):
        if mode & ck.MODE_PCR:  # assembly, the levels, x = b / d and the update
            solve = 9 + 4 + (12 + 4) * levels + 2 + 2
        else:  # assembly with the forward elimination, back substitution
            solve = 9 + 2 + 4
        return reads_state + 3 + solve

    if mode & ck.MODE_TRBDF2:
        per_stage = iters * ((sweep(fields) if water else 0) + (sweep(fields) if heat else 0) + (2 if water else 0))
        return fields + 2 * fields + 2 * per_stage + 3 * fields + 2 * fields  # f(u^n), c2, copy back
    n = iters * sweep(fields) + 2 * 2  # water sweeps, copies of vartheta_l
    if mode & ck.MODE_BE_SOIL:
        n += iters * sweep(fields) + 2 * 2
    elif heat:
        n += fields + 2
    return n


def bound_ms(ck, costs, mode, dtype, cells, steps, n_iter=60, iters=2, ncol=0, probes=None, read_values=0):
    """``(ms, "bytes" or "operations")``: the larger of the state's bytes
    (the branch's fields, and a LandModel's pond, read and written once per
    launch, and ``read_values`` more values read once: streamed forcing
    rows) over HBM bandwidth and the floating-point instructions (per
    cell, and per column for the surface exchange of ``ncol`` columns, its
    MOST solves with ``probes`` evaluations each) over the card's rate for
    the type (one fused multiply-add, two FLOPs, per lane and clock)."""
    def instructions(ops):
        return ops["op"] + sum(ops[k] * costs[dtype][k] for k in costs[dtype])

    itemsize = torch.finfo(dtype).bits // 8
    pond = ncol if mode & ck.MODE_LAND else 0
    t_bytes = (2 * (state_fields(ck, mode) * cells + pond) + read_values) * itemsize / HBM_BYTES_PER_S
    total = (cells * instructions(cell_step_ops(ck, mode, n_iter, iters))
             + ncol * instructions(column_step_ops(ck, mode, dtype, probes, iters)))
    t_ops = steps * total / (PEAK_FLOPS[dtype] / 2)
    return (1e3 * t_ops, "operations") if t_ops >= t_bytes else (1e3 * t_bytes, "bytes")


def _np(Y):
    """The soil fields of a state as float64 arrays, and a LandModel's pond
    as ``h_s``."""
    out = {k: _host(v) for k, v in Y["soil"].items()}
    if "surface" in Y:
        out["h_s"] = _host(Y["surface"]["h_s"])
    return out


def _host(v):
    """A float64 array of ``v`` that shares no memory with it: a tensor on
    the card is copied to the host once, a CPU tensor's array is copied."""
    arr = v.detach().double().cpu().numpy()
    return arr if v.device.type == "cuda" else arr.copy()


def _assert_allclose(actual, desired, rtol, atol, err_msg):
    """``np.testing.assert_allclose`` with its bars, in one pass where it
    passes: arrays of one shape whose every value is within them (no NaN,
    no infinity apart) pass it by ``np.isclose``, on the same arguments;
    any other pair (shapes that differ, even where they broadcast, included)
    runs the full assertion, which fails and reports as before."""
    if np.shape(actual) != np.shape(desired) or not np.isclose(actual, desired, rtol=rtol, atol=atol).all():
        np.testing.assert_allclose(actual, desired, rtol=rtol, atol=atol, err_msg=err_msg)


def _max_abs(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def _check(a, b, dtype, what):
    """The repo's bars: f64 rtol 1e-12 (atol 1e-16, the pond 1e-18); f32
    atol 2e-4 on the water contents, relative 5e-4 on rho_e_int and 1e-4 of
    its largest value on the pond (on the fields the branch has)."""
    if dtype == torch.float64:
        for k in a:
            _assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-18 if k == "h_s" else 1e-16, err_msg=f"{what}/{k}")
        return
    if "h_s" in a:
        _assert_allclose(a["h_s"], b["h_s"], rtol=0, atol=1e-4 * float(np.max(np.abs(b["h_s"]))),
                         err_msg=f"{what}/h_s")
    for k in ("vartheta_l", "theta_i"):
        if k in a:
            _assert_allclose(a[k], b[k], rtol=0, atol=2e-4, err_msg=f"{what}/{k}")
    if "rho_e_int" in a:
        rel = np.abs(a["rho_e_int"] - b["rho_e_int"]) / (np.abs(b["rho_e_int"]) + 1e3)
        if not np.max(rel) < 5e-4:
            raise AssertionError(f"{what}/rho_e_int: relative error {np.max(rel)} >= 5e-4")


def _projection_allowance(model, dtype):
    """``(water, energy)``: what two ulps of T (in ``dtype``, at T_0) move
    the equilibrium partition by, at the steepest slope of the freezing curve
    below T_0 (``_check_freeze``); zeros without ``EquilibriumFreezeThaw``."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, equilibrium_unfrozen_liquid

    if not isinstance(model.freeze_thaw, EquilibriumFreezeThaw):
        return 0.0, 0.0
    ps = model.earth_param_set
    T = torch.linspace(ps.T_0 - 30.0, ps.T_0 - 1e-6, 300001, dtype=torch.float64)[:, None]
    hm = model.hydrology_model.hydraulic_model
    theta = equilibrium_unfrozen_liquid(hm, T.to(model.device), model.soil_param_set.nu, ps)
    slope = float((torch.diff(theta.double(), dim=0) / torch.diff(T.to(theta.device), dim=0)).abs().max())
    ulp = float(np.spacing(np.dtype(str(dtype)[6:]).type(ps.T_0)))
    water = 2 * ulp * slope * ps.rho_cloud_liq / ps.rho_cloud_ice
    return water, ps.rho_cloud_liq * ps.LH_f0 * water


def carried_allowance(model, dtype, projections):
    """Per field, the absolute allowance ``_check_increment`` adds in
    float64 after ``projections`` equilibrium projections (``projections``
    times one projection's, as ``_check_freeze`` carries it): there the
    change bar, 1e-9 of the change, is below one projection's spread.
    ``None`` in float32, whose change bar (0.1 of the change) is not, after
    one projection, and without ``EquilibriumFreezeThaw``."""
    water, energy = _projection_allowance(model, dtype)
    if projections <= 1 or not water or dtype != torch.float64:
        return None
    return {"vartheta_l": projections * water, "theta_i": projections * water, "rho_e_int": projections * energy}


#: after several equilibrium projections, the most cells (a share of the field, and at least
#: FREEZE_CARRIED_CELLS) that may pass one projection's allowance (``_check_freeze``)
FREEZE_CARRIED_SHARE, FREEZE_CARRIED_CELLS = 1e-5, 4


def _check_freeze(kern, plain, model, dtype, what, projections=1):
    """State bars for the freeze-thaw paths at width.

    rho_e_int crosses zero at the freezing front, where its sensible and
    latent terms (~1e7 J/m3) cancel, and theta_i starts at zero, so each
    field's atol is its rtol (1e-12 in f64, 5e-4 in f32) times the field's
    largest magnitude; in f32 the water contents keep the atol 2e-4 of
    ``_check``.  With ``EquilibriumFreezeThaw`` the bisection resolves T_eq
    to adjacent floating-point numbers, and one ulp of T moves the partition
    by up to max |d theta_l,max / dT| (the steepest slope of the freezing
    curve below T_0, computed here) and rho_e_int, through the temperature
    the next stage diagnoses, by up to rho_l LH_f0 times that; both fields
    get that much more for two ulps.  A LandModel's pond keeps the bars of
    ``_check``.

    Checked after ``projections`` projections (the steps of a launch), a
    cell carries each step's difference on into the next (the water moves
    it by diffusion, and the next projection partitions it again), so up to
    ``FREEZE_CARRIED_SHARE`` of the cells (at least ``FREEZE_CARRIED_CELLS``)
    may pass one projection's allowance, by at most ``projections`` times
    it; they are printed.  Every other cell meets one projection's bar.  The
    pond integrates the potential infiltration through the top cell, which
    each projection partitions, so it carries that spread (in f64 in every
    column): after several projections it is held by the change bar of
    ``_check_increment`` alone (1e-9 of its largest change in f64, 0.1 in
    f32), and its deviation printed."""
    rtol = {torch.float64: 1e-12, torch.float32: 5e-4}[dtype]
    water_extra, energy_extra = _projection_allowance(model, dtype)
    for k in kern:
        if k == "h_s" and water_extra and projections > 1:
            dev = float(np.max(np.abs(kern[k] - plain[k])))
            print(f"[{what}] h_s: largest deviation {dev:.3e} m, {dev / float(np.max(np.abs(plain[k]))):.3e} of the "
                  "largest pond; held to its change (_check_increment)", flush=True)
            continue
        if k == "h_s":
            _check({k: kern[k]}, {k: plain[k]}, dtype, what)
            continue
        scale = float(np.max(np.abs(plain[k])))
        extra = energy_extra if k == "rho_e_int" else water_extra
        base = rtol * scale if dtype == torch.float64 or k == "rho_e_int" else 2e-4
        rel = rtol if dtype == torch.float64 or k == "rho_e_int" else 0.0
        if projections > 1 and extra:
            diff, bar = np.abs(kern[k] - plain[k]), rel * np.abs(plain[k])
            past = diff > bar + base + extra
        if projections > 1 and extra and past.any():
            carried = int(past.sum())
            most = max(FREEZE_CARRIED_CELLS, int(FREEZE_CARRIED_SHARE * diff.size))
            worst = float(np.max(diff[past] - bar[past] - base)) / extra
            print(f"[{what}] {k}: {carried} of {diff.size} cells past one projection's allowance, the farthest "
                  f"{worst:.2f} times it (bar: at most {most} cells, {projections} times it)", flush=True)
            if not (carried <= most and worst <= projections):
                raise AssertionError(f"{what}/{k}: {carried} cells past one projection's allowance (at most {most}), "
                                     f"the farthest {worst:.2f} times it (at most {projections})")
            continue
        _assert_allclose(kern[k], plain[k], rtol=rel, atol=base + extra, err_msg=f"{what}/{k}")
    return water_extra, energy_extra


#: bar on the kernel's change of a field from the start state, against the
#: plain version's change, as a share of the plain version's largest change
INCREMENT_RTOL = {torch.float64: 1e-9, torch.float32: 0.1}


def _check_increment(kern, plain, start, dtype, what, moving, extra=None):
    """Hold the kernel's change from ``start`` to the plain version's.

    The state bars of ``_check`` cannot fail a kernel that changes the state
    too little: in f32 the main path's 96 steps move vartheta_l by about
    1e-4, under the 2e-4 bar.  So per field the bar is ``INCREMENT_RTOL``
    times the plain version's largest change plus eight units of rounding of
    the field's largest value, and each field in ``moving`` must change by
    at least five times its bar, so a kernel that leaves it unchanged, or
    takes a third of the steps, fails.  ``extra`` adds an absolute allowance
    per field to its bar (``carried_allowance``: the equilibrium partition's
    spread after several projections).  Returns the error over the largest
    change of each moving field."""
    eps = float(torch.finfo(dtype).eps)
    shares = {}
    for k in kern:
        dk, dp = kern[k] - start[k], plain[k] - start[k]
        scale = max(float(np.max(dp)), -float(np.min(dp)))
        bar = (INCREMENT_RTOL[dtype] * scale + 8 * eps * max(float(np.max(start[k])), -float(np.min(start[k])))
               + (extra or {}).get(k, 0.0))
        err = float(np.max(np.abs(np.subtract(dk, dp, out=dk), out=dk)))
        if not err <= bar:
            raise AssertionError(f"{what}/{k}: change differs by {err:.3e} > bar {bar:.3e}")
        if k in moving:
            if not (scale > 0.0 and scale >= 5 * bar):
                raise AssertionError(
                    f"{what}/{k}: largest change {scale:.3e} is under 5x the bar {bar:.3e}"
                )
            shares[k] = err / scale
    return shares


def _time_ms(fn, reps):
    _quiet()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _fmt(shares):
    return ", ".join(f"{k} {v:.3e}" for k, v in shares.items())


def _clone(Y):
    return {group: {k: v.clone() for k, v in fields.items()} for group, fields in Y.items()}


#: the script's start on the host clock (``main`` sets it), for ``_mark`` inside phases
T_START = time.perf_counter()


def _mark(t_start, what):
    """One line with the script's time so far, at the end of a phase or a part of one."""
    print(f"[clock] {what} done at {time.perf_counter() - t_start:.1f} s", flush=True)


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def profile_main_path(dtype, device, smi, coefficient_update):
    """Phase 7 (``--profile``) at the phase-4 shape, with stage (B1) or
    lagged (B2) coefficients; prints one line per measurement and the
    profiler's table of the busiest device operations."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
    from landhydrology_tpu_torch.timestepping import SSPRK33

    points = NZ * NCOL * SPC
    model, Y0, Ya = build_bench_model(NZ, NCOL, dtype, device)
    model = dataclasses.replace(model, coefficient_update=coefficient_update)
    run = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=SPC)
    name = f"{str(dtype)[6:]} {run.name}"
    Yk = _clone(Y0)
    run(Yk, 0.0)
    ck.fused_column_run_plain(model, SSPRK33(), DT, SPC, Y0, 0.0)
    kern, plain = [], []
    for _ in range(6):  # in turns, so a drift of the clock shows in both
        kern.append(_time_ms(lambda: run(Yk, 0.0), 1))
        plain.append(_time_ms(lambda: ck.fused_column_run_plain(model, SSPRK33(), DT, SPC, Y0, 0.0), 1))
    for what, ms in (("kernel", kern), ("plain", plain)):
        med = float(np.median(ms))
        print(f"[7 profile] {name} {what} ms per {SPC} steps: {[round(x, 3) for x in ms]} median "
              f"{med:.3f} -> {points / (med / 1e3):.4e} grid-points/s on {smi}", flush=True)
    for _ in range(60):  # about a second of queued launches: read the clock under load
        run(Yk, 0.0)
    load = _smi("clocks.sm,power.draw,temperature.gpu")
    torch.cuda.synchronize()
    print(f"[7 profile] {name} under load: SM clock, power draw, temperature = {load}", flush=True)
    for tile in (32, 64, 128, 256):
        r = ck.make_fused_column_run(model, SSPRK33(), dt=DT, steps_per_call=SPC, tile_cols=tile)
        r(Yk, 0.0)
        print(f"[7 profile] {name} tile_cols={tile}: {_time_ms(lambda: r(Yk, 0.0), 5):.3f} ms "
              f"per {SPC} steps", flush=True)

    def simulate():
        """Wall ms of one ``Simulation.run``; the simulation is built (and
        its CFL estimate made) before the clock starts."""
        sim = Simulation(
            model, SSPRK33(), Y_init=_clone(Y0), Ya_init=Ya, dt=DT, tspan=(0.0, N_STEPS * DT),
            saveat=SPC * DT, engine="fused", steps_per_call=SPC,
        )
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    simulate()
    walls = [simulate() for _ in range(3)]
    rates = [NZ * NCOL * N_STEPS / (w / 1e3) for w in walls]
    print(f"[7 profile] {name} Simulation.run ({N_STEPS} steps, saved every {SPC}) wall ms "
          f"{[round(w, 3) for w in walls]} -> {[f'{r:.4e}' for r in rates]} grid-points/s "
          f"end to end", flush=True)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        wall = simulate()
    # device-side events only (kernels and copies): the host operators' own
    # device times would count each kernel twice.  Busy time is the union of
    # their intervals, so records that overlap are counted once.
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_device:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in on_device)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy = (busy + hi - lo) / 1e3
    first_to_last = (max(e for _, e in spans) - spans[0][0]) / 1e3
    kernel = sum(e.time_range.elapsed_us() for e in on_device if "ssprk33_column_kernel" in e.name) / 1e3
    print(f"[7 profile] {name} profiled Simulation.run wall {wall:.3f} ms; {len(on_device)} device "
          f"operations busy {busy:.3f} ms (union) over {first_to_last:.3f} ms from first to last, "
          f"busy share of wall {busy / wall:.4f}; kernel {kernel:.3f} ms = {kernel / wall:.4f} of "
          f"wall, {kernel / busy:.4f} of busy time", flush=True)
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    print(events.table(sort_by=key, row_limit=8), flush=True)


def drive_path(ck, model, Y0, Ya, dt, n_steps, spc, what, moving, stepper=None, projections=1, change_of=None,
               plain_steps=None):
    """One main path: ``Simulation(model, stepper, engine="fused")``
    (SSPRK33 by default) for ``n_steps`` steps saved every ``spc``, with the
    launch counts set to 0 just before the run and read just after, held
    against the plain version (``_check``, or ``_check_freeze`` with
    freeze-thaw after ``projections`` projections, and ``_check_increment``
    with ``carried_allowance``, on the quantities ``change_of`` maps a state
    to where given, else on the state's fields).  With ``plain_steps`` (a
    cut of plain launches, for the script's time) the path's saves are
    checked finite as before, and the plain version holds a launch of that
    many steps from the start state (outside the path's count) instead of
    the path's launches (phase 6 then prints that launch's plain time,
    ``_PATH_CHECKED_STEPS``).  Returns the kernel's final state, its launch
    count, its largest deviation from the plain version and the run's wall
    time in ms (host clock, synchronized)."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.timestepping import SSPRK33

    stepper = SSPRK33() if stepper is None else stepper
    dtype = model.float_dtype
    soil = getattr(model, "soil", model)
    name = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=spc).name
    sim = Simulation(
        model, stepper, Y_init=Y0, Ya_init=Ya, dt=dt, tspan=(0.0, n_steps * dt),
        saveat=spc * dt, engine="fused", steps_per_call=spc,
    )
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    t_wall = time.perf_counter()
    sol = sim.run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t_wall) * 1e3
    launches = dict(ck.LAUNCHES)
    if launches != {name: n_steps // spc}:
        raise AssertionError(f"{what}: expected {n_steps // spc} launches of {name}, counted {launches}")
    saves = n_steps // spc + 1
    expect_ts = torch.arange(saves, dtype=torch.float64) * (spc * torch.tensor(dt, dtype=dtype)).double()
    if not torch.allclose(sol.ts.double().cpu(), expect_ts, rtol=1e-6, atol=0):
        raise AssertionError(f"{what}: saved times {sol.ts.tolist()}")
    for group, fields in sol.us.items():
        for k, v in fields.items():
            if tuple(v.shape) != (saves, *Y0[group][k].shape) or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{what}: saved {k} has shape {tuple(v.shape)} or non-finite values")
    Yp, t = Y0, torch.as_tensor(0.0, dtype=dtype)
    key = _path_key(model, Y0, dt, spc, stepper)
    _PATH_PLAIN_MS[key] = []
    final = _np(sim.Y)
    checked, launches_checked = spc, n_steps // spc
    if plain_steps is not None:  # a launch of plain_steps from the start state, held to the plain version
        checked, launches_checked = plain_steps, 1
        projections = min(projections, plain_steps)
        _PATH_CHECKED_STEPS[key] = plain_steps
        Yk = _clone(Y0)
        ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=plain_steps)(Yk, 0.0)
    for i in range(launches_checked):
        if i == 0 and ck.kernel_mode(model, stepper) & ck.MODE_MOST:
            # phase 6 reads its solves' probes
            Yp, solves, probes, ms = _counting_solves(lambda: ck.fused_column_run_plain(model, stepper, dt, checked,
                                                                                        Yp, t))
            _PATH_PROBES[key] = (solves, probes)
        else:
            torch.cuda.synchronize()
            clock = time.perf_counter()
            Yp = ck.fused_column_run_plain(model, stepper, dt, checked, Yp, t)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - clock) * 1e3
        _PATH_PLAIN_MS[key].append(ms)
        t = t + spc * torch.as_tensor(dt, dtype=dtype)
    torch.cuda.synchronize()
    kern, plain = (final if plain_steps is None else _np(Yk)), _np(Yp)
    extra = ""
    if soil.freeze_thaw is None:
        _check(kern, plain, dtype, what)
    else:
        water, energy = _check_freeze(kern, plain, soil, dtype, what, projections)
        extra = f" (freeze bars: partition +{water:.3e}, rho_e_int +{energy:.3e})" if water else ""
    held = change_of or (lambda Y: Y)
    shares = _check_increment(held(kern), held(plain), held(_np(Y0)), dtype, what, moving,
                              carried_allowance(soil, dtype, projections))
    err = _max_abs(kern, plain)
    first = next(iter(kern))
    held = "" if plain_steps is None else f" (held by a launch of {plain_steps} steps)"
    print(f"[{what}] {str(dtype)[6:]} {name} Simulation(engine='fused') {tuple(Y0['soil'][first].shape)} "
          f"{n_steps} steps: {launches[name]} launches, finite, kernel vs plain max abs {err:.3e}{held} "
          f"({first} {np.max(np.abs(kern[first] - plain[first])):.3e}); change error / "
          f"largest change {_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g}){extra}; wall {wall:.3f} ms",
          flush=True)
    return final, launches[name], err, wall


def _counting_solves(fn):
    """``(fn(), solves, probes, ms)``: ``fn`` run with the MOST solve
    (``surface_conditions``) wrapped to keep each call's ``probes``: the
    solves per column, and the mean per solve and column of the probes its
    rounds evaluate when each stops at its first probe past the sign
    change, as the kernel's solve does (``probes`` ``None`` without a
    solve); ``ms`` the host time of ``fn`` (synchronized), which the wrapper
    costs one list append per solve (the counts are read after it)."""
    from landhydrology_tpu_torch.models.soil import surface_fluxes as sf

    solve, counts = sf.surface_conditions, []

    def counted(*args, **kwargs):
        out = solve(*args, **kwargs)
        counts.append(out["probes"])
        return out

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)  # also run on the CPU
    sf.surface_conditions = counted
    sync()
    clock = time.perf_counter()
    try:
        out = fn()
        sync()
    finally:
        sf.surface_conditions = solve
    ms = (time.perf_counter() - clock) * 1e3
    if not counts:
        return out, 0, None, ms
    total = sum(float(c.double().sum()) for c in counts)
    return out, len(counts), total / (len(counts) * counts[0].numel()), ms


#: ``(solves, probes)`` of a path's first plain launch, counted while
#: ``drive_path`` checks the path, keyed by ``_path_key``: ``most_probes``
#: takes them from here rather than running that launch again
_PATH_PROBES = {}
#: the steps of the plain check of the paths ``drive_path`` held by a shorter launch (``plain_steps``)
_PATH_CHECKED_STEPS = {}
#: the host ms of each of a path's plain launches in its check (synchronized; the one under the
#: counting shim too, which adds a list append per solve), by ``_path_key``: ``time_mode`` takes them
#: rather than running the plain version again
_PATH_PLAIN_MS = {}


def _path_key(model, Y0, dt, spc, stepper):
    return id(model), id(Y0), float(dt), int(spc), type(stepper).__name__


def most_probes(ck, model, stepper, dt, spc, Y0, forcing=None, forcing_time_grid=None):
    """``(solves, probes)`` of the MOST solves in the plain version's launch
    of ``spc`` steps from ``Y0`` at t0 = 0 (with ``forcing``, its rows;
    ``_counting_solves``), or of that launch in ``drive_path``'s check;
    ``(0, None)`` without a MOST top."""
    key = _path_key(model, Y0, dt, spc, stepper)
    if forcing is None and key in _PATH_PROBES:
        return _PATH_PROBES[key]
    _, solves, probes, _ = _counting_solves(lambda: ck.fused_column_run_plain(
        model, stepper, dt, spc, Y0, 0.0, forcing=forcing, forcing_time_grid=forcing_time_grid))
    return solves, probes


def time_mode(ck, model, Y0, dt, spc, stepper=None):
    """``(kernel ms, plain ms, MOST probes)`` per launch of ``spc`` steps:
    CUDA events, kernel x3 twice (two samples; x5 twice before phase 18's
    cuts); the plain version's
    launches of the path's check (``_PATH_PLAIN_MS``, host clock,
    synchronized: one sample per launch), or for a path no check timed the
    plain version once (one sample).  A MOST mode's probes are those of its
    check's first launch (``most_probes``), checked to be one solve per
    exchange."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    stepper = SSPRK33() if stepper is None else stepper
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=spc)
    Yk = _clone(Y0)
    run(Yk, 0.0)  # warm-up
    fused_column = lambda: run(Yk, 0.0)  # noqa: E731
    plain_column = lambda: ck.fused_column_run_plain(model, stepper, dt, spc, Y0, 0.0)  # noqa: E731
    mode = ck.kernel_mode(model, stepper)
    solves, probes = most_probes(ck, model, stepper, dt, spc, Y0) if mode & ck.MODE_MOST else (0, None)
    steps = _PATH_CHECKED_STEPS.get(_path_key(model, Y0, dt, spc, stepper), spc)
    expect = steps * plain_solves(ck, mode, getattr(stepper, "iters", 2)) if mode & ck.MODE_MOST else 0
    if solves != expect:
        raise AssertionError(f"{run.name}: {solves} MOST solves in the plain launch, expected {expect}")
    k1 = _time_ms(fused_column, 3)
    k2 = _time_ms(fused_column, 3)
    checked = _PATH_PLAIN_MS.get(_path_key(model, Y0, dt, spc, stepper))
    return (k1, k2), tuple(checked) if checked else (_time_ms(plain_column, 1),), probes


def host_per_launch(ck, model, Y0, Ya, dt, spc, stepper, reps=5):
    """Where a launch's host time goes, in ms (host clock, medians of
    ``reps``): the whole call of a ``FusedColumnRun`` (it returns once the
    kernel is queued), the tables it builds (BC, profile, surface and rain
    tables, ``FusedColumnRun.tables``) built alone the same way (not
    waiting for their copies to the card), and a warm
    ``Simulation.run`` of ``reps`` launches against the kernel time alone
    (CUDA events) of as many launches."""
    from landhydrology_tpu_torch import Simulation

    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=spc)
    Y = _clone(Y0)
    run(Y, 0.0)
    field = next(iter(Y[getattr(model, "soil", model).name].values()))
    ncol, device = field.shape[1], field.device
    calls, tables = [], []
    for i in range(reps):
        t0 = i * spc * dt
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(Y, t0)
        calls.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run.tables(ncol, device, t0)
        tables.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    sim = Simulation(model, stepper, Y_init=Y0, Ya_init=Ya, dt=dt, tspan=(0.0, reps * spc * dt),
                     saveat=spc * dt, engine="fused", steps_per_call=spc)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    kernel = reps * _time_ms(lambda: run(Y, 0.0), reps)
    return float(np.median(calls)), float(np.median(tables)), wall, kernel


def check_golden(ck, model, Y, dt, n_steps, golden, what, stepper=None, atol=None, plain_steps=None):
    """f64 through the kernel in one launch against a golden (or, with
    ``golden=None``, against the plain version alone), rtol 1e-12 (with
    ``atol``: within that absolute distance of the golden's vartheta_l).
    With ``plain_steps`` (a golden given) the plain version holds a launch
    of that many steps from the start state instead of the whole run."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    stepper = SSPRK33() if stepper is None else stepper
    checked = n_steps if plain_steps is None else plain_steps
    plain = _np(ck.fused_column_run_plain(model, stepper, dt, checked, Y, 0.0))
    start = _clone(Y) if plain_steps is not None else None
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n_steps)
    run(Y, 0.0)
    torch.cuda.synchronize()
    kern = _np(Y)
    held = kern
    if plain_steps is not None:
        ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=plain_steps)(start, 0.0)
        held = _np(start)
    name = run.name
    line = f"[3 golden] f64 {name} {what}:"
    if golden is not None and atol is not None:
        dev = float(np.max(np.abs(kern["vartheta_l"] - golden["vartheta_l"])))
        if not dev <= atol:
            raise AssertionError(f"{what}: vartheta_l {dev:.3e} from the golden > {atol:g}")
        line += f" kernel vs golden vartheta_l max abs {dev:.3e} (bar {atol:g});"
    elif golden is not None:
        for k in kern:
            _assert_allclose(kern[k], golden[k], rtol=1e-12, atol=1e-16, err_msg=f"{what}/{k}")
        rel = max(float(np.max(np.abs(kern[k] - golden[k]) / (np.abs(golden[k]) + 1e-300))) for k in kern)
        line += f" kernel vs golden max rel {rel:.3e} (bar 1e-12);"
    _check(held, plain, torch.float64, f"{what} plain")
    by = "" if plain_steps is None else f" (held by a launch of {plain_steps} steps)"
    print(f"{line} vs plain max abs {_max_abs(held, plain):.3e}{by}", flush=True)
    return kern


def check_variant(ck, model, Y, dt, n_steps, t0, what, moving, stepper=None, geometry=None, check=_check,
                  plain=None, increment_extra=None, forcing=None, forcing_time_grid=None):
    """One launch of ``n_steps`` from ``t0`` (on ``streamed_geometry`` where
    given, with the ``forcing`` rows, on ``forcing_time_grid``, where
    given), with the launch counts set to 0 just before it and read just
    after, against the plain version (its state ``plain`` where the caller
    ran it): ``check`` (``_check`` by default) and ``_check_increment``
    (with ``increment_extra``)."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    stepper = SSPRK33() if stepper is None else stepper
    dtype = model.float_dtype
    start = _np(Y)
    if plain is None:
        plain = ck.fused_column_run_plain(model, stepper, dt, n_steps, Y, t0, geometry=geometry, forcing=forcing,
                                          forcing_time_grid=forcing_time_grid)
    plain = _np(plain)
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n_steps, streamed_geometry=geometry,
                                   forcing_fields=tuple(forcing or ()), forcing_time_grid=forcing_time_grid)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    run(Y, t0, forcing=forcing)
    torch.cuda.synchronize()
    if dict(ck.LAUNCHES) != {run.name: 1}:
        raise AssertionError(f"{what}: launches {dict(ck.LAUNCHES)}, expected one of {run.name}")
    kern = _np(Y)
    check(kern, plain, dtype, what)
    shares = _check_increment(kern, plain, start, dtype, what, moving, increment_extra)
    return kern, plain, shares



def kernel_of(ck, mode, dtype):
    """``(kernel name, source path in the repo)`` of the instance that runs
    ``mode``."""
    lib, _ = ck._entry(mode, dtype)
    kernel = {"implicit_kernel": "implicit_column_kernel", "implicit_most_kernel": "implicit_column_kernel",
              "implicit_branch_kernel": "implicit_column_kernel", "land_kernel": "land_column_kernel",
              "land_policy_kernel": "land_column_kernel", "land_rk_kernel": "land_column_kernel",
              "land_policy_rk_kernel": "land_column_kernel", "land_columns_kernel": "land_column_kernel",
              "land_policy_columns_kernel": "land_column_kernel", "rk_kernel": "rk_column_kernel",
              "rk_columns_kernel": "rk_column_kernel", "implicit_policy_kernel": "implicit_column_kernel",
              "implicit_columns_kernel": "implicit_column_kernel",
              "implicit_most_columns_kernel": "implicit_column_kernel",
              "tile_columns_kernel": "tile_column_kernel"}.get(
                  lib, "ssprk33_column_kernel")
    return kernel, os.path.relpath(ck.SOURCES[lib], HERE)


def water_in(Y, dz):
    """Column water plus the pond, per column: sum(vartheta_l +
    rho_i/rho_l theta_i) dz + h_s."""
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps

    soil = {k: v.double() for k, v in Y["soil"].items()}
    water = (soil["vartheta_l"] + (ps.rho_cloud_ice / ps.rho_cloud_liq) * soil["theta_i"]).sum(0) * dz
    return water + Y["surface"]["h_s"].double()


def evaporation(model, Y, t):
    """The exchange's evaporation (evap_soil + evap_pond, m/s) per column
    at the state (eager, float64)."""
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.models.land import _exchange_from_state

    soil = model.soil
    grid = make_function_space(soil.domain, soil.float_dtype, soil.device)
    ex = _exchange_from_state(model, grid, Y, {"zc": grid.zc, soil.name: {}}, torch.as_tensor(t, dtype=soil.float_dtype))
    return (ex["evap_soil"] + ex["evap_pond"]).double()


#: phase 10's paths at width: 32 steps in one launch (a depth cut for the script's time)
LAND_WIDE_STEPS = 32
#: phase 10's settings held to the plain version by a launch of LAND_CHECKED_STEPS steps (phase 19's cut of plain
#: launches, and phase 20's of the reference and production settings'), in f32 but the MOST soil's (its f32
#: change error is 3e-2 of the change over the launch, under the bar of 0.1: too near it for a shorter launch)
LAND_CHECKED_STEPS = 4


def land_phase(ck, gc, device, smi):
    """Phase 10: the small checks of every B5/B6 mode in f64 (and the
    1,000-column variants in f32 too), the land golden through the eager
    engine on the card, then ``bench.py``'s ``land`` path at full width in
    the reference (B6) and production (B2+B6-step) settings, with the water
    budget and the host time per launch.  Returns the paths to time."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.timestepping import SSPRK33

    small = (
        ("test_pallas_kernel.py:215 MOST column", "B5", 20.0, 4),
        ("test_pallas_kernel.py:278 LandModel", "B6", 2.0, 24),
        ("test_land_model.py:862", "B6-step", 2.0, 48),
    )
    finals = {}
    for what, case, dt, n in small:
        if case == "B5":
            from landhydrology_tpu_torch import PrescribedAtmosForcing, SoilColumnBC, VerticalFlux

            base, Y = build_kernel_test_model(VerticalFlux(0.0), VerticalFlux(0.0), 16, 256, torch.float64, device)
            model = dataclasses.replace(base, boundary_conditions=SoilColumnBC(
                top=PrescribedAtmosForcing(u_atm=0.34, theta_atm=299.0, z_atm=0.05, theta_scale=299.0,
                                           rho_a_sfc=1.17, q_atm=0.015),
                bottom=base.boundary_conditions.bottom))
        elif case == "B6":
            model, Y = build_pallas_land(torch.float64, device)
        else:
            model, Y = build_step_land(torch.float64, device)
        runs = [(case, model)] if case != "B6-step" else [
            ("B6-step", model), ("B6", dataclasses.replace(model, surface_update="stage"))]
        for name, m in runs:
            kern, plain, shares = check_variant(ck, m, _clone(Y), dt, n, 0.0, f"10 land {what}",
                                                ("vartheta_l", "rho_e_int"))
            if ck.make_fused_column_run(m).name != name:
                raise AssertionError(f"{what}: mode {ck.make_fused_column_run(m).name}, expected {name}")
            finals[(what, name)] = kern
            pond = f", max h_s {np.max(kern['h_s']):.4e}" if "h_s" in kern else ""
            print(f"[10 land] f64 {name} {what}, {n} steps of dt={dt}: kernel vs plain max abs "
                  f"{_max_abs(kern, plain):.3e}; change error / largest change {_fmt(shares)}{pond}", flush=True)
        if case == "B6" and not float(np.max(kern["h_s"])) > 1e-6:
            raise AssertionError(f"{what}: no pond formed")
    step, stage = finals[("test_land_model.py:862", "B6-step")], finals[("test_land_model.py:862", "B6")]
    dev = max(float(np.max(np.abs(step[k] - stage[k]))) for k in ("vartheta_l", "h_s"))
    if not dev > 0.0:
        raise AssertionError("B6-step equals B6: the frozen exchange was dropped")
    print(f"[10 land] f64 B6-step vs B6 (test_land_model.py:862): max deviation {dev:.3e} (> 0: the flag "
          "is honoured)", flush=True)

    for dtype in (torch.float64, torch.float32):
        for case in ("B5", "B2+B5", "B6", "B6-step", "B2+B6-step", "B6-pond", "B6-step-pond", "B2+B6-pond",
                     "B2+B6-step-pond"):
            model, Y = build_land_variant(1000, dtype, device, seed=13, case=case)
            kern, plain, shares = check_variant(ck, model, Y, 2.0, COLD_STEPS_F64 if dtype == torch.float64 else 8,
                                                5.0, f"10 land variant {dtype} {case}", ("vartheta_l", "rho_e_int"))
            if ck.make_fused_column_run(model).name != case:
                raise AssertionError(f"variant: mode {ck.make_fused_column_run(model).name}, expected {case}")
            print(f"[10 land] {str(dtype)[6:]} {case} ncol=1000 per-column atmosphere (both Businger "
                  f"branches), callable theta_scale: kernel vs plain max abs {_max_abs(kern, plain):.3e}; "
                  f"change error / largest change {_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g})", flush=True)

    # the land golden through the eager engine on the card: the routing's only check here
    golden = np.load(os.path.join(HERE, "tests", "data", "golden_land_f64.npz"))
    land, Y, Ya, dt = gc.build_land_model_and_state(torch.float64, device)
    sim = Simulation(land, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=dt, tspan=(0.0, gc.LAND_STEPS * dt))
    sim.run()
    final = _np(sim.Y)
    for k in ("vartheta_l", "theta_i", "rho_e_int", "h_s"):
        ref = golden["surface__h_s" if k == "h_s" else k]
        np.testing.assert_allclose(final[k], ref, rtol=1e-12, atol=1e-18, err_msg=f"land golden/{k}")
    rel = max(float(np.max(np.abs(final[k] - golden["surface__h_s" if k == "h_s" else k])
                           / np.abs(golden["surface__h_s" if k == "h_s" else k]).clip(1e-300)))
              for k in ("vartheta_l", "rho_e_int", "h_s"))
    print(f"[10 land] f64 eager Simulation on the card (MOST, pond, kinematic-wave routing, 4 x 4) vs "
          f"golden_land_f64.npz: max rel {rel:.3e} (bar 1e-12)", flush=True)

    paths = []
    settings = (  # (setting, build_land_model's keywords, what runs)
        ("reference", {}, "land"),
        ("production", {"surface_update": "step", "coefficient_update": "step"}, "land"),
        ("frozen exchange", {"surface_update": "step"}, "land"),
        ("lagged", {"coefficient_update": "step"}, "land"),
        ("plain top", {}, "pond"),
        ("plain top, frozen exchange", {"surface_update": "step"}, "pond"),
        ("plain top, lagged", {"coefficient_update": "step"}, "pond"),
        ("plain top, production", {"surface_update": "step", "coefficient_update": "step"}, "pond"),
        ("MOST soil", {}, "soil"),
        ("MOST soil, lagged", {"coefficient_update": "step"}, "soil"),
    )
    _mark(T_START, "phase 10's checks")
    for dtype in (torch.float32, torch.float64):
        ends = {}
        for setting, kw, what in settings:
            land, Y0, Ya = build_land_model(NZ, NCOL, dtype, device, **kw)
            model = land
            if what == "soil":
                model, Y0 = land.soil, {"soil": Y0["soil"]}
            elif what == "pond":
                model = dataclasses.replace(land, soil=dataclasses.replace(land.soil, boundary_conditions=(
                    dataclasses.replace(land.soil.boundary_conditions, top=build_bench_model(
                        NZ, 32, dtype, device)[0].boundary_conditions.top))))
            moving = ("vartheta_l", "rho_e_int", "h_s") if what != "soil" else ("vartheta_l", "rho_e_int")
            short = dtype == torch.float64 or what != "soil"
            kern, launches, err, wall = drive_path(ck, model, Y0, Ya, DT, LAND_WIDE_STEPS, SPC, "10 land", moving,
                                                   plain_steps=LAND_CHECKED_STEPS if short else None)
            paths.append((model, Y0, DT, SPC, launches, err, SSPRK33()))
            ends[setting] = kern
            name = ck.make_fused_column_run(model).name
            if what != "soil":
                dz = land.soil.domain.height / NZ
                end = {"soil": {k: torch.as_tensor(kern[k], device=device) for k in Y0["soil"]},
                       "surface": {"h_s": torch.as_tensor(kern["h_s"], device=device)}}
                change = water_in(end, dz) - water_in(Y0, dz)
                rain = 8e-6 * LAND_WIDE_STEPS * DT
                end = {g: {k: v.to(dtype) for k, v in f.items()} for g, f in end.items()}
                horizon = LAND_WIDE_STEPS * DT
                evap = 0.5 * (evaporation(model, Y0, 0.0) + evaporation(model, end, horizon)) * horizon
                budget = change - (rain - evap)
                print(f"[10 land] {str(dtype)[6:]} {name} water budget per column: change of column water + "
                      f"h_s {float(change.mean()):.6e} m (mean), rain {rain:.6e} m, evaporation (trapezoid of "
                      f"the exchange at the start and end) {float(evap.mean()):.6e} m; change - (rain - "
                      f"evaporation) max abs {float(budget.abs().max()):.3e} m", flush=True)
            if setting in ("reference", "production"):
                call, tables, sim_wall, kernel = host_per_launch(ck, model, Y0, Ya, DT, SPC, SSPRK33())
                print(f"[10 land] {str(dtype)[6:]} {name} host per launch: call {call:.3f} ms, tables alone "
                      f"{tables:.3f} ms; warm Simulation.run of 5 launches {sim_wall:.3f} ms against "
                      f"{kernel:.3f} ms of kernel time on {smi}", flush=True)
        dev = float(np.max(np.abs(ends["production"]["vartheta_l"] - ends["reference"]["vartheta_l"])))
        dev_h = float(np.max(np.abs(ends["production"]["h_s"] - ends["reference"]["h_s"])))
        print(f"[10 land] {str(dtype)[6:]} B2+B6-step vs B6 at width: max |vartheta_l| deviation {dev:.3e}, "
              f"max |h_s| deviation {dev_h:.3e}", flush=True)
        torch.cuda.empty_cache()
    return paths


# ---- phase 11: the forced-reanalysis path, kernel mode B7 ----

#: ``experiments/soil/forced_reanalysis.py``'s run (nz, ncol, dt, window,
#: steps per launch), cut from its 2-day horizon (1,440 steps) to two windows (of 240 steps until phase 20's
#: depth cut, of 120 since)
FORCED_NZ, FORCED_NCOL, FORCED_DT, FORCED_WINDOW, FORCED_SPC, FORCED_STEPS = 24, 131072, 120.0, 120, 24, 240
#: the experiment's horizon (``--days``), which sets the rain band's speed
FORCED_DAYS = 2.0
#: the plain version's check at width takes every 128th column (1,024)
FORCED_STRIDE = 128
#: the forced water budget's bar, a share of the largest column's rain
BUDGET_SHARE = 1e-2


def build_reanalysis(nz, ncol, dtype, device):
    """``experiments/soil/forced_reanalysis.py:123-150`` built with the
    port's API: the flagship LandModel (2 m of loam-like soil,
    vanGenuchten(2.0, 2.6, 3e-7, 0.05), nu 0.4) under a MOST atmosphere
    (2 m/s, 294 K at 2 m, q 0.004; the forcing rows replace the wind, air
    temperature, humidity and rain), tau_pond 600 s, zero-flux bottom;
    moisture 0.18 at 290 K, no pond."""
    from landhydrology_tpu_torch import (
        Column, PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
        SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.land import LandModel, SurfaceWaterModel, initialize_states
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy

    soil = SoilModel(
        domain=Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=3e-7, theta_r=0.05)),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=294.0, z_atm=2.0, theta_scale=294.0, rho_a_sfc=1.2,
                                       q_atm=0.004),
            bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
        ),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6), dtype=dtype, device=device,
    )
    land = LandModel(soil=soil, surface=SurfaceWaterModel(tau_pond=600.0))

    def ic(z, m):
        th = torch.full((nz, ncol), 0.18, dtype=dtype, device=device)
        ti = torch.zeros_like(th)
        rcs = volumetric_heat_capacity(th, ti, 1.3e6, ps)
        return {"vartheta_l": th, "theta_i": ti,
                "rho_e_int": volumetric_internal_energy(ti, rcs, torch.full_like(th, 290.0), ps)}

    Y, Ya = initialize_states(land, ic, 0.0, h_s0=0.0)
    return land, Y, Ya


def reanalysis_forcing(n_steps, ncol, dt, days=FORCED_DAYS):
    """``(times, rows)`` of ``experiments/soil/forced_reanalysis.py:97-116``,
    float32: per-column diurnal wind, air temperature and humidity with a
    random phase per column (``default_rng(0)``), and a rain band of 6e-6
    m/s, a tenth of the columns wide, sweeping across them over ``days``."""
    rng = np.random.default_rng(0)
    t = (np.arange(n_steps) * dt).astype(np.float64)
    phase = rng.uniform(0.0, 2 * np.pi, ncol).astype(np.float32)
    day = (2 * np.pi * t[:, None] / 86400.0).astype(np.float32) + phase
    band = (np.arange(ncol, dtype=np.float32) / ncol)[None, :]
    front = (t[:, None] / (days * 86400.0)).astype(np.float32)
    rain = np.where(np.abs(band - front) < 0.05, np.float32(6e-6), np.float32(0.0))
    fields = {
        "u_atm": 2.0 + 1.5 * np.sin(day),
        "theta_atm": 294.0 + 8.0 * np.sin(day - 0.5),
        "q_atm": 0.004 + 0.002 * np.cos(day),
        "precipitation": rain,
    }
    return t, {k: v.astype(np.float32) for k, v in fields.items()}


def diurnal_rows(n_steps, ncol, dt, rng):
    """``tests/test_forcing_driver.py::_diurnal_forcing``: per-column wind,
    air temperature and humidity cycles with a random phase per column."""
    t = np.arange(n_steps) * dt
    phase = rng.uniform(0.0, 2 * np.pi, ncol)
    day = 2 * np.pi * t[:, None] / 86400.0 + phase[None, :]
    return {"u_atm": 2.0 + 1.5 * np.sin(day), "theta_atm": 295.0 + 8.0 * np.sin(day - 0.5),
            "q_atm": 0.004 + 0.002 * np.cos(day)}


def forced_plain(ck, model, dt, spc, Y, t0, rows):
    """The plain version of a forced fused segment: launches of ``spc`` rows
    and a remainder, as ``make_forced_segment_run(engine="fused")`` runs
    them."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    n = next(iter(rows.values())).shape[0]
    t = torch.as_tensor(t0, dtype=model.float_dtype)
    for c0 in range(0, n, spc):
        m = min(spc, n - c0)
        Y = ck.fused_column_run_plain(model, SSPRK33(), dt, m, Y, t, forcing={k: v[c0:c0 + m] for k, v in rows.items()})
        t = t + m * dt
    return Y


def check_forced(kern, plain, start, dtype, what):
    """The forced path's state bars: ``_check`` and ``_check_increment`` on
    the fields that move (a LandModel's pond too)."""
    _check(kern, plain, dtype, what)
    moving = [k for k in ("vartheta_l", "rho_e_int", "h_s") if k in kern]
    return _check_increment(kern, plain, start, dtype, what, moving)


def forced_evaporation(model, Y, rows, i, t):
    """``evaporation`` of the model with row ``i`` of the forcing installed."""
    from landhydrology_tpu_torch.runtime.forcing_driver import _install_forcing_rows, _split_routing

    atmos, precip = _split_routing(model, tuple(rows))
    return evaporation(_install_forcing_rows(model, {k: v[i] for k, v in rows.items()}, atmos, precip), Y, t)


def launch_by_launch(advance, model, Y0, rows, dt, spc, keep=()):
    """Advance ``Y0`` over ``rows`` one launch of ``spc`` rows at a time
    (``advance(Y, t, chunk) -> (Y, t)``), sampling the exchange's
    evaporation at each launch boundary under the row that starts there (the
    last row at the end).  Returns the end state, the states after the
    launches numbered in ``keep``, and the evaporation per column (m,
    trapezoid over the boundaries)."""
    n = next(iter(rows.values())).shape[0]
    Y, t, kept = Y0, torch.as_tensor(0.0, dtype=model.float_dtype), {}
    rates = [forced_evaporation(model, Y0, rows, 0, t)]
    for c in range(n // spc):
        Y, t = advance(Y, t, {k: v[c * spc:(c + 1) * spc] for k, v in rows.items()})
        if c in keep:
            kept[c] = _clone(Y)
        rates.append(forced_evaporation(model, Y, rows, min((c + 1) * spc, n - 1), t))
    evap = sum(0.5 * (a + b) for a, b in zip(rates, rates[1:])) * spc * dt
    return Y, kept, evap


def check_budget(model, start, end, rows, dt, evap, what):
    """Water budget of a forced land run per column: the change of column
    water plus pond against the rows' rain (floored at zero, as land.py
    floors it) less the evaporation ``evap`` (``launch_by_launch``), within
    ``BUDGET_SHARE`` of the largest column's rain, which must be positive.
    Returns ``(mean change, largest rain, mean evaporation, largest
    residual)`` in m."""
    dz = model.soil.domain.height / model.soil.domain.nelements
    rain = torch.clamp(rows["precipitation"].double(), min=0.0).sum(0) * dt
    change = water_in(end, dz) - water_in(start, dz)
    residual = float((change - (rain - evap)).abs().max())
    rain_max = float(rain.max())
    if not (rain_max > 0.0 and residual <= BUDGET_SHARE * rain_max):
        raise AssertionError(
            f"{what}: water budget residual {residual:.3e} m over {BUDGET_SHARE:g} of the largest column's "
            f"rain {rain_max:.3e} m"
        )
    return float(change.mean()), rain_max, float(evap.mean()), residual


class TimedReader:
    """A ForcingReader that records the host time of each window read."""

    def __init__(self, reader):
        self.reader, self.read_ms = reader, []

    def __getattr__(self, name):
        return getattr(self.reader, name)

    def read_into(self, i0, nt, out):
        t = time.perf_counter()
        self.reader.read_into(i0, nt, out)
        self.read_ms.append((time.perf_counter() - t) * 1e3)


def time_forced(ck, run, model, Y0, rows, dt, spc, forcing_time_grid=None, stepper=None, checked=None):
    """``(kernel ms, plain ms, MOST probes)`` per forced launch of ``spc``
    steps of ``stepper`` (SSPRK33 by default) from ``Y0`` with ``rows``:
    the plain version once under ``_counting_solves``, which gives the
    probes and its time (one sample), or ``checked``, ``(plain ms,
    probes)`` of the caller's check launch so counted; then CUDA events,
    kernel x5 twice (averaged)."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    stepper = SSPRK33() if stepper is None else stepper
    Yk = _clone(Y0)
    run(Yk, 0.0, forcing=rows)  # warm-up
    kernel = lambda: run(Yk, 0.0, forcing=rows)  # noqa: E731
    if checked is None:
        plain = lambda: ck.fused_column_run_plain(  # noqa: E731
            model, stepper, dt, spc, Y0, 0.0, forcing=rows, forcing_time_grid=forcing_time_grid)
        _, _, probes, plain_ms = _counting_solves(plain)
    else:
        plain_ms, probes = checked
    k1, k2 = _time_ms(kernel, 5), _time_ms(kernel, 5)
    return (k1 + k2) / 2, plain_ms, probes


def forced_small(ck, gc, device):
    """Phase 11's checks at the JAX tests' sizes, each through the kernel and
    the plain version on the card: the forced golden, the JAX fused
    engine's forced cases (a scalar row and a remainder launch; per-column
    rain ponding a LandModel; time-indexed rows clamped at both table ends)
    and 1,000-column variants of every B5/B6 mode with forcing rows."""
    from landhydrology_tpu_torch.models.land import LandModel, SurfaceWaterModel, initialize_states
    from landhydrology_tpu_torch.models.soil import SoilHydrologyModel, vanGenuchten
    from landhydrology_tpu_torch.runtime import make_forced_segment_run
    from landhydrology_tpu_torch.timestepping import SSPRK33

    f64 = torch.float64
    golden = np.load(os.path.join(HERE, "tests", "data", "golden_forced_f64.npz"))
    model, Y, Ya, rows, dt = gc.build_forced_model_state_and_rows(f64, device)

    def segment(m, Y0, Ya0, r, spc, what, expect):
        plain = _np(forced_plain(ck, m, dt, spc, Y0, 0.0, r))
        ck.LAUNCHES.clear()
        Yk, _ = make_forced_segment_run(m, SSPRK33(), dt=dt, field_names=sorted(r), engine="fused",
                                        steps_per_call=spc)(Y0, Ya0, 0.0, r)
        torch.cuda.synchronize()
        if dict(ck.LAUNCHES) != expect:
            raise AssertionError(f"{what}: launches {dict(ck.LAUNCHES)}, expected {expect}")
        kern = _np(Yk)
        shares = check_forced(kern, plain, _np(Y0), f64, what)
        return kern, plain, shares

    kern, plain, shares = segment(model, Y, Ya, rows, 8, "forced golden", {"B5+B7": 5})
    for k in kern:
        np.testing.assert_allclose(kern[k], golden[k], rtol=1e-12, atol=1e-16, err_msg=f"forced golden/{k}")
    rel = max(float(np.max(np.abs(kern[k] - golden[k]) / (np.abs(golden[k]) + 1e-300))) for k in kern)
    print(f"[11 forced] f64 B5+B7 golden (40 steps in 5 launches, scalar u_atm and per-column rows) vs "
          f"golden_forced_f64.npz: max rel {rel:.3e} (bar 1e-12); vs plain max abs {_max_abs(kern, plain):.3e}",
          flush=True)

    r29 = {k: torch.as_tensor(v, dtype=f64, device=device)
           for k, v in diurnal_rows(29, 16, dt, np.random.default_rng(7)).items()}
    r29["theta_atm"] = r29["theta_atm"][:, 0].contiguous()
    kern, plain, shares = segment(model, Y, Ya, r29, 8, "test_forcing_driver.py:191", {"B5+B7": 4})
    print(f"[11 forced] f64 B5+B7 test_forcing_driver.py:191 (29 steps, 8 per launch and a remainder of 5, "
          f"scalar theta_atm row): kernel vs plain max abs {_max_abs(kern, plain):.3e}; change error / largest "
          f"change {_fmt(shares)}", flush=True)

    soil = dataclasses.replace(model, hydrology_model=SoilHydrologyModel(
        hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=2e-7, theta_r=0.05)))
    land = LandModel(soil=soil, surface=SurfaceWaterModel(tau_pond=240.0))
    Yl, Yal = initialize_states(land, lambda z, m: {k: v.clone() for k, v in Y["soil"].items()}, 0.0, h_s0=0.0)
    rain = np.zeros((24, 16))
    rain[4:12] = 8e-6
    rl = {k: torch.as_tensor(v, dtype=f64, device=device)
          for k, v in dict(precipitation=rain, **diurnal_rows(24, 16, dt, np.random.default_rng(3))).items()}
    kern, plain, shares = segment(land, Yl, Yal, rl, 8, "test_forcing_driver.py:225", {"B6+B7": 3})
    if not float(np.max(kern["h_s"])) > 1e-5:
        raise AssertionError("forced land: the rain rows did not pond")
    print(f"[11 forced] f64 B6+B7 test_forcing_driver.py:225 (per-column rain rows pond a LandModel, max h_s "
          f"{np.max(kern['h_s']):.4e} m): kernel vs plain max abs {_max_abs(kern, plain):.3e}; change error / "
          f"largest change {_fmt(shares)}", flush=True)

    tables = {"u_atm": torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=f64, device=device),
              "q_atm": torch.as_tensor(0.003 + 0.001 * np.arange(4)[:, None] + np.zeros((4, 16)), device=device)}
    grid = (200.0, 100.0, 4)
    plain = _np(ck.fused_column_run_plain(model, SSPRK33(), 100.0, 9, Y, 0.0, forcing=tables, forcing_time_grid=grid))
    ck.LAUNCHES.clear()
    Yt = ck.make_fused_column_run(model, SSPRK33(), dt=100.0, steps_per_call=9, forcing_fields=("q_atm", "u_atm"),
                                  forcing_time_grid=grid)(_clone(Y), 0.0, forcing=tables)
    seq = [0, 0, 0, 1, 2, 3, 3, 3, 3]
    Ys = ck.make_fused_column_run(model, SSPRK33(), dt=100.0, steps_per_call=9, forcing_fields=("q_atm", "u_atm"))(
        _clone(Y), 0.0, forcing={k: v[seq] for k, v in tables.items()})
    torch.cuda.synchronize()
    if dict(ck.LAUNCHES) != {"B5+B7-time": 1, "B5+B7": 1}:
        raise AssertionError(f"clamped rows: launches {dict(ck.LAUNCHES)}")
    kern = _np(Yt)
    shares = check_forced(kern, plain, _np(Y), f64, "test_forcing_driver.py:544")
    same = all(np.array_equal(kern[k], v) for k, v in _np(Ys).items())
    if not same:
        raise AssertionError("time-indexed rows differ from the step-indexed rows 0, 0, 0, 1, 2, 3, 3, 3, 3")
    print(f"[11 forced] f64 B5+B7-time test_forcing_driver.py:544 (4-row table from t=200, 9 steps of dt=100 from "
          f"t=0: clamped at both ends, a step on a row boundary): kernel vs plain max abs "
          f"{_max_abs(kern, plain):.3e}; equal bit for bit to the step-indexed rows {seq}", flush=True)

    for dtype in (f64, torch.float32):
        for case in ("B5", "B2+B5", "B6", "B6-step", "B2+B6", "B2+B6-step", "B6-pond", "B6-step-pond",
                     "B2+B6-pond", "B2+B6-step-pond"):
            m, Yv = build_land_variant(1000, dtype, device, seed=13, case=case)
            n, time_indexed = 4, case in ("B2+B5", "B6-step", "B2+B6-step-pond")
            n_rows = 5 if time_indexed else n
            rv = variant_rows(m, case, n_rows)
            tg = (6.0, 1.5, n_rows) if time_indexed else None
            plain = _np(ck.fused_column_run_plain(m, SSPRK33(), 2.0, n, Yv, 5.0, forcing=rv, forcing_time_grid=tg))
            run = ck.make_fused_column_run(m, SSPRK33(), dt=2.0, steps_per_call=n, forcing_fields=tuple(rv),
                                           forcing_time_grid=tg)
            start = _np(Yv)
            kern = _np(run(Yv, 5.0, forcing=rv))
            torch.cuda.synchronize()
            shares = check_forced(kern, plain, start, dtype, f"11 forced variant {dtype} {run.name}")
            print(f"[11 forced] {str(dtype)[6:]} {run.name} ncol=1000 per-column rows ({', '.join(rv)}; both "
                  f"Businger branches): kernel vs plain max abs {_max_abs(kern, plain):.3e}; change error / "
                  f"largest change {_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g})", flush=True)


def forced_phase(ck, gc, device, smi, costs):
    """Phase 11: ``forced_small``, then the forced-reanalysis path at full
    width (``build_reanalysis``, ``FORCED_STEPS`` steps of the experiment's
    forcing written to a file and read back through ``run_forced``, with and
    without overlap), its checks and times.  Returns the kernel records of
    its launches."""
    import tempfile

    from landhydrology_tpu_torch.runtime import ForcingReader, make_forced_segment_run, run_forced, write_forcing
    from landhydrology_tpu_torch.timestepping import SSPRK33

    forced_small(ck, gc, device)
    _mark(T_START, "phase 11's small checks")
    entries = []
    nz, ncol, dt, spc, n = FORCED_NZ, FORCED_NCOL, FORCED_DT, FORCED_SPC, FORCED_STEPS
    points = nz * ncol * n
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "forcing.bin")
        t = time.perf_counter()
        times, rows_np = reanalysis_forcing(n, ncol, dt)
        write_forcing(path, times, rows_np)
        print(f"[11 forced] forcing file: {n} steps x {ncol} columns x {len(rows_np)} fields float32 = "
              f"{os.path.getsize(path) / 1e9:.3f} GB, made and written in {time.perf_counter() - t:.3f} s", flush=True)
        fields = sorted(rows_np)
        cols = torch.arange(0, ncol, FORCED_STRIDE, device=device)
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype)[6:]
            land, Y0, Ya = build_reanalysis(nz, ncol, dtype, device)
            rows = {k: torch.from_numpy(v).to(device).to(dtype) for k, v in rows_np.items()}
            seg = make_forced_segment_run(land, SSPRK33(), dt=dt, field_names=fields, engine="fused",
                                          steps_per_call=spc)
            Yref, tref = seg(Y0, Ya, 0.0, rows)  # (a)'s reference: the rows in memory
            torch.cuda.synchronize()
            walls, reads = {True: [], False: []}, {True: [], False: []}
            # in turns, the first run also pinning the buffers; one run each in f64, whose kernel-bound path the
            # overlap moves little (a cut for the script's time)
            for overlap in (False, True, True, False) if dtype == torch.float32 else (False, True):
                torch.cuda.synchronize()
                ck.LAUNCHES.clear()
                t = time.perf_counter()
                with ForcingReader(path) as base:
                    reader = TimedReader(base)
                    Yf, tf = run_forced(land, Y0, Ya, reader, SSPRK33(), dt=dt, window=FORCED_WINDOW,
                                        engine="fused", steps_per_call=spc, overlap=overlap)
                    torch.cuda.synchronize()
                    walls[overlap].append((time.perf_counter() - t) * 1e3)
                    hits, native = base.prefetch_hits, base.is_native
                reads[overlap] += reader.read_ms
                launches = dict(ck.LAUNCHES)
                if launches != {"B6+B7": n // spc}:
                    raise AssertionError(f"run_forced: launches {launches}, expected {n // spc} of B6+B7")
                if not (hits > 0 and native):  # (d)
                    raise AssertionError(f"run_forced: prefetch hits {hits}, native reader {native}")
                for g, f in Yref.items():  # (a): the same kernel on the same rows
                    for k, v in f.items():
                        if not torch.equal(Yf[g][k], v):
                            raise AssertionError(f"run_forced (overlap={overlap}) differs from the in-memory "
                                                 f"segment in {k}")
                if float(tf) != float(tref):
                    raise AssertionError(f"run_forced ends at t={float(tf)}, the segment at {float(tref)}")
                if overlap:
                    main_launches = launches["B6+B7"]
            end = _np(Yf)
            if not all(np.isfinite(v).all() for v in end.values()):
                raise AssertionError("forced run: non-finite state")
            # the in-memory segment again, launch by launch: the evaporation at
            # each launch boundary for (c), the state after the first launch for (b)
            Yc, kept, evap = launch_by_launch(lambda Y, t, r: seg(Y, Ya, t, r), land, Y0, rows, dt, spc, keep=(0,))
            for g, f in Yref.items():
                for k, v in f.items():
                    if not torch.equal(Yc[g][k], v):
                        raise AssertionError(f"the segment launch by launch differs from one call in {k}")
            # (b): 1,024 columns through the plain version for the first launch
            m = spc
            small, Ys, _ = build_reanalysis(nz, cols.numel(), dtype, device)
            r_cols = {k: v[:m, cols].contiguous() for k, v in rows.items()}
            plain, _, check_probes, check_ms = _counting_solves(
                lambda: forced_plain(ck, small, dt, spc, Ys, 0.0, r_cols))
            plain = _np(plain)
            kern = {k: v[..., cols.cpu().numpy()] for k, v in _np(kept[0]).items()}
            shares = check_forced(kern, plain, _np(Ys), dtype, f"11 forced {tag} columns")
            print(f"[11 forced] {tag} B6+B7 nz={nz} x {ncol}, {m} steps: every {FORCED_STRIDE}th column against "
                  f"the plain version on those columns' rows: max abs {_max_abs(kern, plain):.3e}; change error / "
                  f"largest change {_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g})", flush=True)
            # (c): the water budget of the whole run
            change, rain_max, evap, residual = check_budget(land, Y0, Yf, rows, dt, evap, f"forced {tag}")
            print(f"[11 forced] {tag} B6+B7 water budget per column over {n} steps: change of column water + h_s "
                  f"{change:.6e} m (mean), largest column rain {rain_max:.6e} m, evaporation (trapezoid over the "
                  f"{n // spc} launches) {evap:.6e} "
                  f"m (mean); largest residual {residual:.3e} m (bar {BUDGET_SHARE:g} of the largest rain); max h_s "
                  f"{np.max(end['h_s']):.4e} m", flush=True)
            # times: the kernel per launch, the window's host legs, the bound
            run = ck.make_fused_column_run(land, SSPRK33(), dt=dt, steps_per_call=spc, forcing_fields=fields)
            chunk = {k: v[:spc] for k, v in rows.items()}
            k_ms, p_ms, probes = time_forced(ck, run, land, Y0, chunk, dt, spc, checked=(check_ms, check_probes))
            mode = run.mode
            b_ms, b_by = bound_ms(ck, costs, mode, dtype, nz * ncol, spc, ncol=ncol, probes=probes,
                                  read_values=len(fields) * spc * ncol)
            with ForcingReader(path) as reader:
                pinned = torch.empty((FORCED_WINDOW, len(fields), ncol), dtype=torch.float32, pin_memory=True)
                reader.prefetch(0, FORCED_WINDOW)
                reader.read_into(0, FORCED_WINDOW, pinned)
                t = time.perf_counter()
                reader.read_into(0, FORCED_WINDOW, pinned)  # served from the staged window: the copy alone
                copy_ms = (time.perf_counter() - t) * 1e3
            side = torch.cuda.Stream(device)
            h2d = []
            for _ in range(3):
                with torch.cuda.stream(side):
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record(side)
                    block = pinned.to(device, non_blocking=True).to(dtype)
                    e1.record(side)
                side.synchronize()
                h2d.append(e0.elapsed_time(e1))
            del block, pinned
            h2d_ms = float(np.median(h2d))
            n_win = n // FORCED_WINDOW
            rates = {o: _fmt_rates(points, w) for o, w in walls.items()}
            busy = {o: "/".join(f"{main_launches * k_ms / x:.3f}" for x in w) for o, w in walls.items()}
            print(f"[11 forced] {tag} B6+B7 nz={nz} x {ncol}, {n} steps of dt={dt:g} ({n_win} windows of "
                  f"{FORCED_WINDOW}, {spc} steps per launch), run_forced end to end incl. IO, {len(walls[True])} run(s) "
                  f"each in turns: overlap {_fmt_ms(walls[True])} = {rates[True]} grid-points/s, no overlap "
                  f"{_fmt_ms(walls[False])} = {rates[False]} grid-points/s; kernel {k_ms:.3f} ms per launch "
                  f"(plain {p_ms:.3f} ms on {cols.numel()} columns, bound {b_ms:.3f} ms by {b_by}, MOST probes per "
                  f"solve {probes:.4f}); device "
                  f"busy share overlap {busy[True]}, no overlap {busy[False]}; host per window: reader (read into the pinned "
                  f"buffer, prefetch wait included) overlap {_fmt_ms(reads[True])}, no overlap "
                  f"{_fmt_ms(reads[False])}; of it the copy of a staged window into pinned memory {copy_ms:.3f} ms; "
                  f"H2D copy (and cast) of a window {h2d_ms:.3f} ms ({4 * FORCED_WINDOW * len(fields) * ncol / h2d_ms / 1e6:.3f} "
                  f"GB/s) on {smi}", flush=True)
            entries.append(dict(forced_entry(ck, run, dtype, main_launches, _max_abs(kern, plain), k_ms, p_ms, b_ms,
                                             b_by), plain_at=f"11b: nz={nz} x {cols.numel()} columns, {spc} steps"))
            del Yref, Yf, Yc, kept, seg, run
            _mark(T_START, f"phase 11's {tag} reanalysis run")
            for setting in ("production", "MOST soil", "time-indexed"):
                entries.append(forced_setting(ck, costs, setting, land, Y0, rows, cols, smi))
            del rows, land, Y0
            torch.cuda.empty_cache()
            _mark(T_START, f"phase 11's {tag} settings")
            for case in FORCED_COMBOS:
                entries.append(forced_combination(ck, costs, smi, case, dtype, device))
            torch.cuda.empty_cache()
    return entries


#: phase 11's timed B7 combinations: their width (a quarter of the
#: reanalysis run's) and modes
FORCED_COMBO_NCOL = 32768
#: the rows of the f64 check of a FORCED_COMBOS mode (phase 19's cut of plain launches: were FORCED_SPC)
FORCED_COMBO_CHECKED = 8
FORCED_COMBOS = ("B2+B5", "B6-step", "B2+B6", "B6-pond", "B6-step-pond", "B2+B6-pond", "B2+B6-step-pond")


def forced_combination(ck, costs, smi, case, dtype, device, ncol=FORCED_COMBO_NCOL):
    """One more B5/B6 mode with streamed rows on the reanalysis model, at
    nz=24 x ``ncol``: ``case`` is ``B2+B5`` (the soil alone, lagged, under
    the atmosphere rows) or a B6 name (``-step`` the frozen exchange, ``B2+``
    lagged coefficients, ``-pond`` the soil's zero-flux top under the rain
    rows alone).  One launch of ``FORCED_SPC`` rows, with the launch counts
    set to 0 just before it and read just after, checked against the plain
    version (its launch counted and timed for the record; in f64 since phase
    19 a launch of the first ``FORCED_COMBO_CHECKED`` rows instead, a cut of
    plain launches), then timed (``time_forced``).  Returns its kernel
    record."""
    from landhydrology_tpu_torch import SoilColumnBC, SoilComponentBC, VerticalFlux
    from landhydrology_tpu_torch.timestepping import SSPRK33

    nz, dt, spc = FORCED_NZ, FORCED_DT, FORCED_SPC
    land, Y0, _ = build_reanalysis(nz, ncol, dtype, device)
    _, rows_np = reanalysis_forcing(spc, ncol, dt)
    rows = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in rows_np.items()}
    soil = dataclasses.replace(land.soil, coefficient_update="step" if case.startswith("B2+") else "stage")
    if case.endswith("-pond"):
        soil = dataclasses.replace(soil, boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0)),
            bottom=soil.boundary_conditions.bottom))
        rows = {"precipitation": rows["precipitation"]}
    if case == "B2+B5":
        model, Y0 = soil, {"soil": Y0["soil"]}
        rows.pop("precipitation")
    else:
        model = dataclasses.replace(land, soil=soil, surface_update="step" if "-step" in case else "stage")
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=spc, forcing_fields=tuple(rows))
    if run.name != f"{case}+B7":
        raise AssertionError(f"forced combination {case}: built {run.name}")
    Yk = _clone(Y0)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    run(Yk, 0.0, forcing=rows)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    if launches != {run.name: 1}:
        raise AssertionError(f"forced combination {case}: launches {launches}")
    checked = FORCED_COMBO_CHECKED if dtype == torch.float64 else spc
    if checked < spc:  # the first rows through a launch of their own, held to the plain version
        rows_checked = {k: v[:checked] for k, v in rows.items()}
        Yk = _clone(Y0)
        ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=checked,
                                 forcing_fields=tuple(rows))(Yk, 0.0, forcing=rows_checked)
    else:
        rows_checked = rows
    plain, _, probes, p_ms = _counting_solves(lambda: forced_plain(ck, model, dt, checked, Y0, 0.0, rows_checked))
    kern, plain = _np(Yk), _np(plain)
    moving = [k for k in ("vartheta_l", "rho_e_int", "h_s") if k in kern and not (k == "rho_e_int" and "pond" in case)]
    _check(kern, plain, dtype, f"11 forced {case}")
    shares = _check_increment(kern, plain, _np(Y0), dtype, f"11 forced {case}", moving)
    k_ms, p_ms, probes = time_forced(ck, run, model, Y0, rows, dt, spc, checked=(p_ms, probes))
    b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, nz * ncol, spc, ncol=ncol, probes=probes,
                          read_values=len(rows) * spc * ncol)
    most = f", MOST probes per solve {probes:.4f}" if probes is not None else ""
    held = "" if checked == spc else f" (held by a launch of its first {checked} rows)"
    print(f"[11 forced] {str(dtype)[6:]} {run.name} nz={nz} x {ncol}, one launch of {spc} rows (launch counts "
          f"{launches}): kernel vs plain max abs {_max_abs(kern, plain):.3e}{held}; change error / largest change "
          f"{_fmt(shares)}; kernel {k_ms:.3f} ms per launch (plain {p_ms:.3f} ms over {checked} rows, bound "
          f"{b_ms:.3f} ms by {b_by}{most}) on {smi}", flush=True)
    entry = forced_entry(ck, run, dtype, launches[run.name], _max_abs(kern, plain), k_ms, p_ms, b_ms, b_by)
    if checked < spc:
        entry["plain_at"] = f"11: nz={nz} x {ncol}, {checked} rows"
    return entry


def variant_rows(model, case, n_rows, seed=17):
    """Forcing rows of a ``build_land_variant`` model of mode ``case``:
    per-column wind and air temperature within 1 K of the model's, a scalar
    humidity row (not under a plain top) and, for a LandModel, per-column
    rain on half the columns, ``n_rows`` of each."""
    soil = getattr(model, "soil", model)
    ncol = soil.domain.batch_shape[0]
    dtype, device = soil.float_dtype, soil.device
    rng = np.random.default_rng(seed)
    tensor = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    rows = {}
    if "pond" not in case:
        rows["u_atm"] = tensor(rng.uniform(0.3, 5.0, (n_rows, ncol)))
        rows["theta_atm"] = soil.boundary_conditions.top.theta_atm[None, :] + tensor(
            rng.uniform(-1.0, 1.0, (n_rows, ncol)))
        rows["q_atm"] = tensor(rng.uniform(0.002, 0.012, n_rows))
    if "B6" in case:
        rows["precipitation"] = tensor(rng.uniform(0.0, 2e-5, (n_rows, ncol)) * (rng.random((n_rows, ncol)) < 0.5))
    return rows


def forced_entry(ck, run, dtype, launches, err, k_ms, p_ms, b_ms, b_by):
    """The kernel record of a forced run's mode."""
    kernel, source = kernel_of(ck, run.mode, dtype)
    return {
        "name": f"{kernel}<{str(dtype)[6:].replace('float', 'f')}, {run.name}>",
        "route": "cuda",
        "source": source,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call computes these steps
    }


def forced_setting(ck, costs, setting, land, Y0, rows, cols, smi):
    """One more forced path at the reanalysis width, over the first window
    (``FORCED_WINDOW // FORCED_SPC`` launches of ``FORCED_SPC`` steps) with the launch counts set to 0
    just before it and read just after: ``"production"`` (the frozen
    exchange and lagged coefficients, B2+B6-step+B7), ``"MOST soil"`` (its
    soil alone under the atmosphere rows, B5+B7) or ``"time-indexed"`` (B6
    with a table of every second row on a grid of 2 dt, B6+B7-time).
    Checked on the strided columns against the plain version over the
    first launch (its launch counted and timed for the record: the plain
    versions are bound by launch latency, not by the columns), and timed.
    Returns its kernel record."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    dt, spc, nz = FORCED_DT, FORCED_SPC, FORCED_NZ
    n_launches = FORCED_WINDOW // spc
    dtype = land.float_dtype
    grid = (0.0, 2 * dt, FORCED_WINDOW // 2) if setting == "time-indexed" else None
    rows = {k: v[:FORCED_WINDOW:2] if grid else v[:FORCED_WINDOW] for k, v in rows.items()
            if not (setting == "MOST soil" and k == "precipitation")}

    def configure(land, Y0):
        if setting == "production":
            return dataclasses.replace(land, surface_update="step", soil=dataclasses.replace(
                land.soil, coefficient_update="step")), Y0
        if setting == "MOST soil":
            return land.soil, {"soil": Y0["soil"]}
        return land, Y0

    model, Y0 = configure(land, Y0)
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=spc, forcing_fields=tuple(rows),
                                   forcing_time_grid=grid)

    def rows_of(c):
        return rows if grid else {k: v[c * spc:(c + 1) * spc] for k, v in rows.items()}

    idx = cols.cpu().numpy()
    Y, t = _clone(Y0), torch.as_tensor(0.0, dtype=dtype)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    for c in range(n_launches):
        run(Y, t, forcing=rows_of(c))
        t = t + spc * dt
        if c == 0:
            first = {k: v[..., idx] for k, v in _np(Y).items()}
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    if launches != {run.name: n_launches}:
        raise AssertionError(f"forced {setting}: launches {launches}, expected {n_launches} of {run.name}")
    if not all(np.isfinite(v).all() for v in _np(Y).values()):
        raise AssertionError(f"forced {setting}: non-finite state")
    small, Ys, _ = build_reanalysis(nz, cols.numel(), dtype, cols.device)  # the start state is uniform
    m_small, Ys = configure(small, Ys)
    r0 = {k: v[:, cols] for k, v in rows_of(0).items()}
    plain, _, probes, p_ms = _counting_solves(lambda: ck.fused_column_run_plain(
        m_small, SSPRK33(), dt, spc, Ys, 0.0, forcing=r0, forcing_time_grid=grid))
    plain = _np(plain)
    shares = check_forced(first, plain, _np(Ys), dtype, f"11 forced {setting}")
    k_ms, p_ms, probes = time_forced(ck, run, model, Y0, rows_of(0), dt, spc, grid, checked=(p_ms, probes))
    n_rows = next(iter(rows_of(0).values())).shape[0]
    b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, nz * FORCED_NCOL, spc, ncol=FORCED_NCOL, probes=probes,
                          read_values=len(rows) * n_rows * FORCED_NCOL)
    print(f"[11 forced] {str(dtype)[6:]} {run.name} ({setting}) nz={nz} x {FORCED_NCOL}, {n_launches} launches "
          f"of {spc} steps: every {FORCED_STRIDE}th column against the plain version over the first launch: max abs "
          f"{_max_abs(first, plain):.3e}; change error / largest change {_fmt(shares)}; kernel {k_ms:.3f} ms per "
          f"launch (plain {p_ms:.3f} ms on {cols.numel()} columns, bound {b_ms:.3f} ms by {b_by}, MOST probes per "
          f"solve {probes:.4f}) on {smi}",
          flush=True)
    return dict(forced_entry(ck, run, dtype, launches[run.name], _max_abs(first, plain), k_ms, p_ms, b_ms, b_by),
                plain_at=f"11: nz={nz} x {cols.numel()} columns, {spc} steps")


# ---- phase 12: the regional-grid path, kernel modes B1-batched and B8 ----

#: ``experiments/soil/regional_grid.py``'s run: nz, ncol, dt, steps per
#: launch, steps (one hour)
GRID_NZ, GRID_NCOL, GRID_DT, GRID_SPC, GRID_STEPS = 48, 131072, 5.0, 48, 720
#: the seed of the variable-depth twin's depths, drawn apart from the script's
GRID_DEPTH_SEED = 11


def build_regional(nz, ncol, dtype, device, variable_depth=False, columns=None):
    """``experiments/soil/regional_grid.py:66-133`` built with the port's API,
    its draws in its order from ``default_rng(7)``: per-column porosity and
    van Genuchten parameters (loam to sand), a top of rain-flux or ponded
    Dirichlet columns and a bottom of free-drainage or zero-flux columns
    (``BatchedBC``), zero energy flux at both faces, 2 m of soil; moisture
    0.3-0.7 of the porosity by column at 288 K.  With ``variable_depth`` the
    columns reach down to -U(0.8, 3.0) m (``default_rng(GRID_DEPTH_SEED)``),
    the rest unchanged.  ``columns`` (indices) keeps those columns of the
    ``ncol`` drawn.  Returns ``(model, Y, Ya, top kinds)``."""
    from landhydrology_tpu_torch import (
        BatchedBC, BCKind, Column, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
        SoilHydrologyModel, SoilModel, SoilParams, VariableDepthColumn, VerticalFlux,
        initialize_states,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import (
        k_solid, ksat_frozen, ksat_unfrozen, volumetric_heat_capacity, volumetric_internal_energy,
    )

    rng = np.random.default_rng(7)
    keep = np.arange(ncol) if columns is None else np.asarray(columns)
    n = keep.size
    tensor = lambda x: torch.as_tensor(x[keep], dtype=dtype, device=device)  # noqa: E731
    nu = tensor(rng.uniform(0.35, 0.52, ncol))
    hm = vanGenuchten(
        n=tensor(rng.uniform(1.4, 3.5, ncol)),
        alpha=tensor(rng.uniform(1.5, 4.5, ncol)),
        Ksat=tensor(10 ** rng.uniform(-7.0, -4.5, ncol)),
        theta_r=tensor(rng.uniform(0.0, 0.08, ncol)),
    )
    ks = k_solid(0.0, 0.6, 7.7, 2.5, 0.25)
    msp = SoilParams(nu=nu, S_s=1e-3, nu_ss_quartz=0.6, rho_c_ds=1.2e6, kappa_solid=ks,
                     kappa_sat_unfrozen=ksat_unfrozen(ks, 0.45, 0.57), kappa_sat_frozen=ksat_frozen(ks, 0.45, 2.29))
    kinds_top = torch.as_tensor(rng.integers(0, 2, ncol)[keep], dtype=torch.int32, device=device)
    rain = tensor(-10 ** rng.uniform(-8.0, -6.5, ncol))
    top_vals = torch.where(kinds_top == BCKind.DIRICHLET, 0.9 * nu, rain)
    kinds_bot = torch.as_tensor(np.where(rng.random(ncol) < 0.5, BCKind.FREE_DRAINAGE, BCKind.FLUX)[keep],
                                dtype=torch.int32, device=device)
    domain = Column(zlim=(-2.0, 0.0), nelements=nz, batch_shape=(n,))
    if variable_depth:
        depths = np.random.default_rng(GRID_DEPTH_SEED).uniform(0.8, 3.0, ncol)[keep]
        domain = VariableDepthColumn(z_bottom=-depths, nelements=nz, batch_shape=(n,))
    model = SoilModel(
        domain=domain,
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=BatchedBC(kind=kinds_top, value=top_vals), energy=VerticalFlux(0.0)),
            bottom=SoilComponentBC(hydrology=BatchedBC(kind=kinds_bot, value=torch.zeros(n, dtype=dtype,
                                                                                          device=device)),
                                   energy=VerticalFlux(0.0)),
        ),
        soil_param_set=msp, dtype=dtype, device=device,
    )

    def ic(z, m):
        theta = ((0.3 + 0.4 * tensor(rng.random(ncol))) * nu).expand(nz, n)
        ti = torch.zeros((nz, n), dtype=dtype, device=device)
        T = torch.full((nz, n), 288.0, dtype=dtype, device=device)
        rcs = volumetric_heat_capacity(theta, ti, 1.2e6, ps)
        return {"vartheta_l": theta, "theta_i": ti, "rho_e_int": volumetric_internal_energy(ti, rcs, T, ps)}

    Y, Ya = initialize_states(model, ic, 0.0)
    return model, Y, Ya, kinds_top


def column_slice(model, Y, idx):
    """The sub-model and state of the columns ``idx`` of a flat column
    batch: every per-column tensor leaf of the model (parameters, BC values
    and kinds) and a variable depth sliced the same way."""
    from landhydrology_tpu_torch.domains import VariableDepthColumn

    ncol = model.domain.batch_shape[0]
    cpu_idx = idx.cpu()

    def cut(obj):
        if torch.is_tensor(obj):
            return obj[idx.to(obj.device)] if obj.dim() == 1 and obj.shape[0] == ncol else obj
        if isinstance(obj, VariableDepthColumn):
            zb = np.broadcast_to(obj.z_bottom, obj.batch_shape)[cpu_idx.numpy()]
            zt = np.broadcast_to(obj.z_top, obj.batch_shape)[cpu_idx.numpy()]
            return dataclasses.replace(obj, z_bottom=zb, z_top=zt, batch_shape=(len(idx),))
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            if hasattr(obj, "batch_shape"):
                return dataclasses.replace(obj, batch_shape=(len(idx),))
            return dataclasses.replace(obj, **{f.name: cut(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                                               if f.init})
        return obj

    sub = {g: {k: v[..., idx].contiguous() for k, v in f.items()} for g, f in Y.items()}
    return cut(model), sub


#: the modes of the 1,000-column variants, with what each draws per column
GRID_VARIANTS = ("B1", "B2", "B3-rate", "B1-water", "B4-be-richards", "B4-be-richards-water", "B4-trbdf2",
                 "B4-trbdf2-water", "B5", "B6", "cross-energy", "cross-water")


def build_grid_variant(ncol, dtype, device, seed, case, nz=16, cold=False, icy=False):
    """A heterogeneous column (the JAX fused tests' soil, nz=16 unless
    given) with per-column features: BC kinds drawn per column at both faces
    (hydrology FLUX or DIRICHLET on top, any of the three below; energy
    FLUX or DIRICHLET, a callable per-column Dirichlet temperature on top),
    and depths from U(0.8, 3.0) m.  ``case`` is a mode of
    ``GRID_VARIANTS``: the coupled SSPRK33 modes, ``B1-water`` (a time- and
    depth-dependent T profile), the implicit modes (returned with their
    stepper), ``B5`` / ``B6`` (a MOST top over a batched bottom), or a
    cross-component case (B1, with temperature-dependent viscosity):
    ``cross-energy``, a plain energy Dirichlet top over hydrology kinds with
    DIRICHLET columns, and ``cross-water``, energy kinds with DIRICHLET
    columns under a plain hydrology Dirichlet; or any plain-soil mode of
    phase 20 (``SOIL_RK_MODES``, ``SOIL_IMPLICIT_MODES``) with its policies
    (lagged, ``-no-ice``, ``B3-rate``, ``B3-eq``) and branch (``-water``,
    ``-heat``: the moisture prescribed as ``build_heat_only`` prescribes it,
    energy kinds at both faces).  With ``cold`` the freeze-thaw and no-ice
    modes start cold, as 16a's column (268-278 K by column, 0.02 of ice), the
    no-ice ones with ``icy`` on its ``icy_state``.  Returns ``(model, Y,
    stepper, dt, steps)``."""
    from landhydrology_tpu_torch import (
        BatchedBC, BCKind, Dirichlet, NoBC, PrescribedAtmosForcing, PrescribedHydrologyModel,
        PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC, VariableDepthColumn, VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as eps
    from landhydrology_tpu_torch.models.land import LandModel, PulsePrecipitation, SurfaceWaterModel
    from landhydrology_tpu_torch.models.soil import TemperatureDependentViscosity
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy
    from landhydrology_tpu_torch.timestepping import SSPRK33

    base, Y = build_kernel_test_model(VerticalFlux(0.0), VerticalFlux(0.0), nz, ncol, dtype, device, seed=seed,
                                      heterogeneous=True)
    rng = np.random.default_rng(seed + 1)
    tensor = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    kinds = lambda n: torch.as_tensor(rng.integers(0, n, ncol), dtype=torch.int32, device=device)  # noqa: E731
    mode = {"cross-energy": "B1", "cross-water": "B1"}.get(case, case)
    solver = next((s for s in IMPLICIT_STEPPERS if mode.startswith(s)), None)
    lagged = mode.startswith("B2") or "+B2" in mode
    freeze = FreezeThaw(tau=60.0) if "B3-rate" in mode else EquilibriumFreezeThaw() if "B3-eq" in mode else None
    no_ice, heat = "-no-ice" in mode, "-heat" in mode
    k_top, k_bot, e_top, e_bot = kinds(2), kinds(3), kinds(2), kinds(2)
    T_top = tensor(rng.uniform(281.0, 293.0, ncol))
    hyd_top = BatchedBC(kind=k_top, value=torch.where(k_top == BCKind.DIRICHLET, tensor(rng.uniform(0.38, 0.44, ncol)),
                                                      tensor(-rng.uniform(1e-7, 1e-5, ncol))))
    hyd_bot = BatchedBC(kind=k_bot, value=torch.where(k_bot == BCKind.DIRICHLET, tensor(rng.uniform(0.3, 0.4, ncol)),
                                                      tensor(rng.uniform(-1e-6, 1e-6, ncol))))
    en_top = BatchedBC(kind=e_top, value=lambda t: T_top + 1e-3 * t)
    en_bot = BatchedBC(kind=e_bot, value=torch.where(e_bot == BCKind.DIRICHLET, tensor(rng.uniform(283.0, 290.0, ncol)),
                                                     tensor(rng.uniform(-3.0, 3.0, ncol))))
    if case == "cross-energy":
        en_top = Dirichlet(lambda t: 292.0 + 1e-3 * t)
    elif case == "cross-water":
        hyd_top = Dirichlet(0.43)
    bottom = SoilComponentBC(hydrology=hyd_bot, energy=en_bot)
    model = dataclasses.replace(base, boundary_conditions=SoilColumnBC(
        top=SoilComponentBC(hydrology=hyd_top, energy=en_top), bottom=bottom))
    if case.startswith("cross"):  # the face temperature enters K through the viscosity
        model = dataclasses.replace(model, hydrology_model=dataclasses.replace(
            model.hydrology_model, viscosity_factor=TemperatureDependentViscosity()))
    model = dataclasses.replace(model, domain=VariableDepthColumn(
        z_bottom=-rng.uniform(0.8, 3.0, ncol), nelements=nz, batch_shape=(ncol,)))
    stepper, dt, steps = SSPRK33(), 0.25, 8
    model = dataclasses.replace(model, coefficient_update="step" if lagged else "stage", assume_no_ice=no_ice)
    if freeze is not None:
        model = dataclasses.replace(model, freeze_thaw=freeze, boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(hydrology=hyd_top, energy=BatchedBC(kind=e_top, value=lambda t: T_top - 20.0)),
            bottom=bottom))
        dt = 2.0
    if cold and (freeze is not None or no_ice):  # 16a's cold column: 268-278 K by column, 0.02 of ice
        theta = Y["soil"]["vartheta_l"]
        ice = torch.full_like(theta, 0.02)
        T = (268.0 + 10.0 * torch.arange(ncol, dtype=dtype, device=device) / ncol).expand_as(theta)
        rho_c_s = volumetric_heat_capacity(theta, ice, model.soil_param_set.rho_c_ds, eps)
        Y = {"soil": {"vartheta_l": theta, "theta_i": ice,
                      "rho_e_int": volumetric_internal_energy(ice, rho_c_s, T, eps)}}
        if no_ice and icy:
            Y = icy_state(model, Y)
    if heat:
        model = dataclasses.replace(
            model, hydrology_model=PrescribedHydrologyModel(
                vartheta_l_profile=lambda z, t: 0.25 + 0.05 * z + 1e-6 * t,
                theta_i_profile=lambda z, t: 0.01 + 0.0 * z),
            boundary_conditions=SoilColumnBC(top=SoilComponentBC(energy=en_top),
                                             bottom=SoilComponentBC(energy=en_bot)))
        Y = {"soil": {"rho_e_int": Y["soil"]["rho_e_int"]}}
    elif "-water" in mode:
        model = dataclasses.replace(
            model, energy_model=PrescribedTemperatureModel(T_profile=lambda z, t: 285.0 + 3.0 * z + 1e-3 * t),
            boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=hyd_top, energy=NoBC()),
                                             bottom=SoilComponentBC(hydrology=hyd_bot, energy=NoBC())))
        Y = {"soil": {k: Y["soil"][k] for k in ("vartheta_l", "theta_i")}}
    if solver:
        stepper = implicit(IMPLICIT_STEPPERS[solver], model, 2)
        dt, steps = 60.0, 4
    if mode in ("B5", "B6"):
        v, ti = Y["soil"]["vartheta_l"][-1], Y["soil"]["theta_i"][-1]
        ps = model.earth_param_set
        T_surface = ps.T_0 + Y["soil"]["rho_e_int"][-1] / (
            model.soil_param_set.rho_c_ds + torch.minimum(v, model.soil_param_set.nu - ti) * ps.rho_cp_l)
        atmos = PrescribedAtmosForcing(
            u_atm=tensor(rng.uniform(0.3, 5.0, ncol)), theta_atm=T_surface + tensor(rng.uniform(-8.0, 8.0, ncol)),
            z_atm=2.0, theta_scale=lambda t: 290.0 + 1e-3 * t, rho_a_sfc=1.2,
            q_atm=tensor(rng.uniform(0.002, 0.012, ncol)))
        model = dataclasses.replace(model, boundary_conditions=SoilColumnBC(top=atmos, bottom=bottom))
        dt = 2.0
        if mode == "B6":
            model = LandModel(soil=model, surface=SurfaceWaterModel(
                precipitation=PulsePrecipitation(rate=5e-6, t_start=0.0, t_stop=12.0), tau_pond=120.0))
            Y = dict(Y, surface={"h_s": tensor(rng.uniform(0.0, 2e-4, ncol))})
    return model, Y, stepper, dt, steps


def per_column_values(run, nz, ncol, dtype):
    """Values the run reads once per launch beyond the state: a per-column
    grid (the centers and the spacing, B8) and per-column kinds (int32,
    counted in values of ``dtype``)."""
    values = nz * ncol + ncol if run.variable else 0
    if run.batched:
        slots = sum(1 for k in run._kinds(ncol, torch.device("cpu")) if k is not None and k[1])
        values += slots * ncol * 4 // (torch.finfo(dtype).bits // 8)
    return values


def build_water_test(depths, bottom, nz, device, dtype=torch.float64):
    """The water-only column of the JAX package's heterogeneity and
    variable-depth tests (``tests/soil/test_batched_heterogeneous.py:36``,
    ``tests/test_variable_depth.py:45``): vanGenuchten(3.0, 2.7, 1e-5,
    0.075), nu 0.3, a Dirichlet top at 0.24 (a callable), ``bottom`` below,
    moisture 0.12; 1.5 m deep, or ``depths`` per column."""
    from landhydrology_tpu_torch import (
        Column, Dirichlet, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC, SoilHydrologyModel,
        SoilModel, SoilParams, VariableDepthColumn,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten

    ncol = len(depths)
    domain = VariableDepthColumn(z_bottom=-np.asarray(depths), nelements=nz, batch_shape=(ncol,))
    if len(set(depths)) == 1:
        domain = Column(zlim=(-depths[0], 0.0), nelements=nz, batch_shape=(ncol,))
    model = SoilModel(
        domain=domain, energy_model=PrescribedTemperatureModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=3.0, alpha=2.7, Ksat=1e-5, theta_r=0.075)),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=Dirichlet(lambda t: 0.24)),
                                         bottom=SoilComponentBC(hydrology=bottom)),
        soil_param_set=SoilParams(nu=0.3, S_s=1e-3), dtype=dtype, device=device,
    )
    Y = {"soil": {"vartheta_l": torch.full((nz, ncol), 0.12, dtype=dtype, device=device),
                  "theta_i": torch.zeros((nz, ncol), dtype=dtype, device=device)}}
    return model, Y


def grid_small(ck, device):
    """Phase 12's checks at the JAX tests' sizes in f64 and the 1,000-column
    variants of every mode that takes per-column kinds or geometry."""
    from landhydrology_tpu_torch import BatchedBC, Column, FreeDrainage
    from landhydrology_tpu_torch.domains import make_function_space

    f64 = torch.float64

    def check(model, Y, dt, n, what, stepper=None, geometry=None):
        kern, plain, shares = check_variant(ck, model, _clone(Y), dt, n, 0.0, f"12 grid {what}", ("vartheta_l",),
                                            stepper=stepper, geometry=geometry)
        name = ck.make_fused_column_run(model, stepper or SSPRK33(), dt=dt, streamed_geometry=geometry).name
        return kern, f"kernel vs plain max abs {_max_abs(kern, plain):.3e}; change error / largest change " \
                     f"{_fmt(shares)}", name

    from landhydrology_tpu_torch.timestepping import SSPRK33

    bottom = BatchedBC(kind=torch.tensor([0, 1, 2], dtype=torch.int32, device=device),
                       value=torch.tensor([-1e-7, 0.15, 0.0], dtype=f64, device=device))
    model, Y = build_water_test([1.5] * 3, bottom, 30, device)
    _, line, name = check(model, Y, 0.25, 120, "batched")
    print(f"[12 grid] f64 {name} test_batched_heterogeneous.py:59 (bottom kinds FLUX, DIRICHLET, FREE_DRAINAGE; "
          f"120 steps of dt=0.25 in one launch): {line}", flush=True)
    depths = list(np.random.default_rng(1).uniform(0.8, 3.0, 8))
    model, Y = build_water_test(depths, FreeDrainage(), 24, device)
    kern, line, name = check(model, Y, 0.25, 6, "depth")
    print(f"[12 grid] f64 {name} test_variable_depth.py:237 (8 columns of U(0.8, 3.0) m, 6 steps of dt=0.25): "
          f"{line}", flush=True)
    grid = make_function_space(model.domain, f64, device)
    flat = dataclasses.replace(model, domain=Column(zlim=(-1.0, 0.0), nelements=24, batch_shape=(8,)))
    for m in (flat, model):
        streamed, _, _ = check(m, Y, 0.25, 6, "streamed", geometry=(grid.dz, grid.zc))
        if not all(np.array_equal(streamed[k], kern[k]) for k in kern):
            raise AssertionError("streamed_geometry of the model's own grid differs from the model-grid run")
    print("[12 grid] f64 B1-water+B8 streamed_geometry=(dz, zc) of the model's own grid, on the variable-depth "
          "model and on a uniform-column model: equal bit for bit to the model-grid run", flush=True)
    model, Y = build_water_test([0.8, 1.5, 3.0], FreeDrainage(), 24, device)
    _, line, name = check(model, Y, 15.0, 40, "implicit", stepper=implicit("BackwardEulerRichards", model, 3))
    print(f"[12 grid] f64 {name} test_variable_depth.py:272 (BackwardEulerRichards(iters=3), 40 steps of dt=15 on "
          f"depths 0.8, 1.5, 3.0 m): {line}", flush=True)
    for dtype in (f64, torch.float32):
        for case in GRID_VARIANTS:
            model, Y, stepper, dt, n = build_grid_variant(1000, dtype, device, 7, case)
            moving = ("vartheta_l", "rho_e_int") if "rho_e_int" in Y["soil"] else ("vartheta_l",)
            kern, plain, shares = check_variant(ck, model, Y, dt, n, 2.0, f"12 grid variant {dtype} {case}", moving,
                                                stepper=stepper)
            run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n)
            nbytes = sum(p.numel() * p.element_size() for p in run.tables(1000, torch.device(device), 2.0)[1]
                         if p is not None)
            tables = f", profile tables {nbytes} B per launch" if nbytes else ""
            print(f"[12 grid] {str(dtype)[6:]} {run.name} ({case}) ncol=1000, {n} steps of dt={dt:g}{tables}: kernel "
                  f"vs plain max abs {_max_abs(kern, plain):.3e}; change error / largest change {_fmt(shares)} (bar "
                  f"{INCREMENT_RTOL[dtype]:g})", flush=True)


def grid_mass(model, Y):
    """Total water (liquid + ice as liquid) over the batch, each column's
    cells times its own spacing, in float64."""
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.domains import make_function_space

    dz = make_function_space(model.domain, torch.float64, "cpu").dz
    soil = {k: v.double().cpu() for k, v in Y["soil"].items()}
    per_column = (soil["vartheta_l"] + (ps.rho_cloud_ice / ps.rho_cloud_liq) * soil["theta_i"]).sum(0)
    return float((per_column * torch.as_tensor(dz)).sum())


def _sound_columns(state):
    """Columns (of ``(nz, ncol)`` arrays) whose every value is finite, with
    vartheta_l within [0, 1]: a column past its explicit limit leaves that
    range on its way to the non-finite numbers, and two correct
    implementations can reach them a few steps apart
    (``tests/test_torch_regional_divergence.py``)."""
    with np.errstate(invalid="ignore"):
        sound = np.all([np.isfinite(v).all(0) for v in state.values()], axis=0)
        return sound & (state["vartheta_l"] >= 0).all(0) & (state["vartheta_l"] <= 1).all(0)


def check_diverged(kern, plain, start, dtype, what, moving, sound=_sound_columns, check=_check, extra=None,
                   change_of=None):
    """The kernel and the plain version must leave the range (``sound``,
    ``_sound_columns`` by default) in the same columns (an explicit step past
    a column's stability limit diverges in both); on the other columns
    ``check`` (``_check`` by default) and ``_check_increment`` (with
    ``extra``, on the quantities ``change_of`` maps a state to where given).
    Returns ``(shares, max abs error, diverged columns)``."""
    fk, fp = sound(kern), sound(plain)
    if not np.array_equal(fk, fp):
        raise AssertionError(f"{what}: the kernel diverges in columns {np.flatnonzero(~fk)[:8]}, the plain version "
                             f"in {np.flatnonzero(~fp)[:8]}")
    kern, plain, start = ({k: v[:, fk] for k, v in x.items()} for x in (kern, plain, start))
    check(kern, plain, dtype, what)
    held = change_of or (lambda Y: Y)
    shares = _check_increment(held(kern), held(plain), held(start), dtype, what, moving, extra)
    return shares, _max_abs(kern, plain), int((~fk).sum())


def _physical_columns(state):
    """Columns whose every value is finite, vartheta_l within [0, 1] and
    |rho_e_int| at most 1e9 J/m^3 (on the fields the branch has): 20c's
    implicit steps of 30 s leave it in a few of the cold columns, in the
    plain version as in the kernel."""
    with np.errstate(invalid="ignore"):
        ok = np.all([np.isfinite(v).all(0) for v in state.values()], axis=0)
        if "vartheta_l" in state:
            ok &= (state["vartheta_l"] >= 0).all(0) & (state["vartheta_l"] <= 1).all(0)
        if "rho_e_int" in state:
            ok &= (np.abs(state["rho_e_int"]) <= 1e9).all(0)
    return ok


def _equal_nan(a, b):
    """Bit for bit, a NaN where the other has one."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


#: the columns each regional hour took out of the range (``regional_path``), per (dtype, variable depth, no ice)
REGIONAL_DIVERGED = {}


def regional_path(ck, costs, smi, dtype, device, variable_depth, no_ice=False, tag="12 grid"):
    """Phase 12 (c) and (d): ``regional_grid.py``'s hour at nz=48 x 131,072
    (``build_regional``, or its variable-depth twin; with ``no_ice``
    ``production_run.py``'s ``assume_no_ice=True``, phase 20a): the first launch at
    full width against the plain version; the script's loop of
    ``make_fused_column_run`` calls and ``Simulation(engine="fused")``, each
    with the launch counts set to 0 just before and read just after, equal
    bit for bit; the columns the kernel takes out of the range over the
    hour (``_sound_columns``; dt=5 s is past the explicit limit of a few
    columns that saturate or pond over thin cells, and they blow up in the
    JAX package too: ``tests/test_torch_regional_divergence.py``) counted,
    at most 4,096, and kept in ``REGIONAL_DIVERGED``; the script's summary,
    on the other columns.  Returns the path to time."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.timestepping import SSPRK33

    nz, ncol, dt, spc, n = GRID_NZ, GRID_NCOL, GRID_DT, GRID_SPC, GRID_STEPS
    prefix, tag = tag, str(dtype)[6:]
    moving = ("vartheta_l", "rho_e_int")
    model, Y0, Ya, kinds_top = build_regional(nz, ncol, dtype, device, variable_depth)
    model = dataclasses.replace(model, assume_no_ice=no_ice)
    run = ck.make_fused_column_run(model, SSPRK33(), dt=dt, steps_per_call=spc)
    name = run.name
    what = f"{prefix} regional {tag} {name}"
    torch.cuda.synchronize()
    clock = time.perf_counter()
    plain = ck.fused_column_run_plain(model, SSPRK33(), dt, spc, Y0, 0.0)
    torch.cuda.synchronize()
    plain_first_s = time.perf_counter() - clock
    _PATH_PLAIN_MS[_path_key(model, Y0, dt, spc, SSPRK33())] = [plain_first_s * 1e3]  # phase 6's sample
    plain = _np(plain)
    Yk = _clone(Y0)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    run(Yk, 0.0)
    torch.cuda.synchronize()
    if dict(ck.LAUNCHES) != {name: 1}:
        raise AssertionError(f"{what}: launches {dict(ck.LAUNCHES)}, expected one of {name}")
    shares1, err1, div1 = check_diverged(_np(Yk), plain, _np(Y0), dtype, f"{what} first launch", moving)
    del plain, Yk

    def advance(model, Y, launch):
        t = torch.as_tensor(0.0, dtype=dtype)
        for _ in range(n // spc):
            Y = launch(model, Y, t)
            t = t + spc * torch.as_tensor(dt, dtype=dtype)
        return Y

    Y = _clone(Y0)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    wall = time.perf_counter()
    e0.record()
    advance(model, Y, lambda m, Y, t: run(Y, t))  # the script's loop
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - wall) * 1e3
    kernel_ms = e0.elapsed_time(e1) / (n // spc)
    loop_launches = dict(ck.LAUNCHES)
    sim = Simulation(model, SSPRK33(), Y_init=Y0, Ya_init=Ya, dt=dt, tspan=(0.0, n * dt), engine="fused",
                     steps_per_call=spc)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    sim_wall = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    sim_wall = (time.perf_counter() - sim_wall) * 1e3
    sim_launches = dict(ck.LAUNCHES)
    for launches in (loop_launches, sim_launches):
        if launches != {name: n // spc}:
            raise AssertionError(f"{what}: launches {launches}, expected {n // spc} of {name}")
    if not all(_equal_nan(sim.Y["soil"][k], Y["soil"][k]) for k in Y["soil"]):
        raise AssertionError(f"{what}: Simulation(engine='fused') differs from the script's loop")
    del sim

    # the columns the kernel takes out of the range over the hour (no plain version's hour, for the script's
    # time: the first launch is held above, the same instance in every launch)
    end = _np(Y)
    sound = _sound_columns(end)
    diverged = np.flatnonzero(~sound)
    if diverged.size > 4096:
        raise AssertionError(f"{what}: {diverged.size} columns diverge")
    REGIONAL_DIVERGED[(dtype, variable_depth, no_ice)] = diverged

    v = end["vartheta_l"][:, sound]
    nu = np.broadcast_to(model.soil_param_set.nu.double().cpu().numpy(), (ncol,))[sound]
    kinds = kinds_top.cpu().numpy()[sound]
    within = bool((v >= 0).all() and (v <= nu).all())
    wetter = bool(v[-1][kinds == 1].mean() > v[-1][kinds == 0].mean())
    if not (within and wetter):
        raise AssertionError(f"{what}: on the other columns vartheta_l within [0, nu] {within}, "
                             f"dirichlet_cols_wetter {wetter}")
    keep = torch.as_tensor(np.flatnonzero(sound), device=device)
    m0, mf = (grid_mass(*column_slice(model, x, keep)) for x in (Y0, Y))
    b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, nz * ncol, spc,
                          read_values=per_column_values(run, nz, ncol, dtype))
    points = nz * ncol * n
    summary = {"ncol": ncol, "nz": nz, "steps": n, "finite": bool(np.isfinite(end["vartheta_l"]).all()),
               "theta_min": float(v.min()), "theta_max": float(v.max()),
               "water_mass_change_frac": (mf - m0) / m0, "dirichlet_cols_wetter": wetter}
    print(f"[{prefix}] {tag} {name} regional_grid.py{' (variable-depth twin)' if variable_depth else ''} nz={nz} x "
          f"{ncol}, {n} steps of dt={dt:g} ({n // spc} launches of {spc}): first launch vs plain max abs {err1:.3e}, "
          f"change error / largest change {_fmt(shares1)} ({div1} columns diverged in both); {diverged.size} of "
          f"{ncol} columns leave the range over the hour (dt past their explicit limit; in the plain version too, "
          f"tests/test_torch_regional_divergence.py): {diverged.tolist()[:100]}, summary on the "
          f"{int(sound.sum())} others; plain version {plain_first_s:.1f} s for the first launch; "
          f"Simulation(engine='fused') equal bit for bit to the script's loop; launches loop {loop_launches}, "
          f"Simulation {sim_launches}; end to end: loop {wall:.3f} ms = {points / (wall / 1e3):.4e} grid-points/s, "
          f"Simulation {sim_wall:.3f} ms = {points / (sim_wall / 1e3):.4e} grid-points/s; kernel {kernel_ms:.3f} ms "
          f"per launch (CUDA events over the loop), bound {b_ms:.3f} ms by {b_by}; summary {json.dumps(summary)} on "
          f"{smi}", flush=True)
    return (model, Y0, dt, spc, loop_launches[name], err1, SSPRK33())


def lateral_eager(device):
    """Phase 12 (e): ``tests/parallel/test_sharding.py``'s lateral case on
    the eager engine on the card: an 8 x 8 batch of coupled 12-cell columns
    with ``LateralSurfaceCoupling(5e-4, 1.0)``, 200 steps of dt=10; the
    total water is conserved to 1e-12 and the surface bump flattens."""
    from landhydrology_tpu_torch import (
        Column, LateralSurfaceCoupling, Simulation, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
        SoilHydrologyModel, SoilModel, SoilParams, VerticalFlux, initialize_states,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil import vanGenuchten
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy
    from landhydrology_tpu_torch.timestepping import SSPRK33

    nz, nx, ny, f64 = 12, 8, 8, torch.float64
    zero = SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0))
    model = SoilModel(
        domain=Column(zlim=(-1.0, 0.0), nelements=nz, batch_shape=(nx, ny)), energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=1e-5, theta_r=0.0)),
        boundary_conditions=SoilColumnBC(top=zero, bottom=zero),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        lateral_coupling=LateralSurfaceCoupling(conductance=5e-4, dx=1.0), device=device,
    )
    x = np.arange(nx)[None, :, None]
    y = np.arange(ny)[None, None, :]
    bump = torch.as_tensor(0.05 * np.sin(2 * np.pi * x / nx) * np.cos(2 * np.pi * y / ny), device=device)

    def ic(z, m):
        theta = (0.2 + bump + 0.0 * z).expand(nz, nx, ny)
        ti = torch.zeros_like(theta)
        T = 288.0 + 5.0 * z + 0.0 * theta
        return {"vartheta_l": theta, "theta_i": ti,
                "rho_e_int": volumetric_internal_energy(ti, volumetric_heat_capacity(theta, ti, 1.3e6, ps), T, ps)}

    Y, Ya = initialize_states(model, ic, 0.0)
    sim = Simulation(model, SSPRK33(), Y_init=Y, Ya_init=Ya, dt=10.0, tspan=(0.0, 2000.0))
    sim.run()
    v0, vf = Y["soil"]["vartheta_l"].to(f64), sim.Y["soil"]["vartheta_l"].to(f64)
    drift = float(abs(vf.sum() - v0.sum()) / v0.sum())
    s0, sf = float(v0[-1].std()), float(vf[-1].std())
    if not (drift < 1e-12 and sf < s0 and bool(torch.isfinite(vf).all())):
        raise AssertionError(f"lateral coupling: water drift {drift:.3e}, surface std {s0:.4e} -> {sf:.4e}")
    print(f"[12 grid] f64 eager LateralSurfaceCoupling(5e-4, 1.0) on the card (test_sharding.py's 8 x 8 batch, 200 "
          f"steps of dt=10): total water drift {drift:.3e} (bar 1e-12), surface std {s0:.4e} -> {sf:.4e}", flush=True)


def grid_phase(ck, costs, smi, device, t_start):
    """Phase 12: ``grid_small``, the regional grid and its variable-depth
    twin at width in f32 and f64 (``regional_path``) and the lateral case
    (``lateral_eager``).  Returns the paths to time."""
    grid_small(ck, device)
    _mark(t_start, "phase 12's small checks")
    paths, failures = [], []
    for dtype in (torch.float32, torch.float64):
        for variable_depth in (False, True):
            try:  # every path runs, so one run shows each path's failure
                paths.append(regional_path(ck, costs, smi, dtype, device, variable_depth))
            except AssertionError as e:
                print(f"[12 grid] FAILED: {e}", flush=True)
                failures.append(str(e))
            torch.cuda.empty_cache()
    _mark(t_start, "phase 12's regional paths")
    time_grid_variants(ck, costs, smi, device)
    _mark(t_start, "phase 12's kinds / B8 instances")
    lateral_eager(device)
    if failures:
        raise AssertionError("phase 12 regional paths failed: " + " | ".join(failures))
    return paths


#: the kinds / B8 instances timed at width: three launches each, the plain version not timed
GRID_TIMED_NZ, GRID_TIMED_NCOL = 48, 32768
#: their implicit modes' dt: at 60 s (``build_grid_variant``'s) three f32 TR-BDF2 columns of
#: nz=48 leave the finite numbers in the plain version as in the kernel; none at 45 s
GRID_TIMED_IMPLICIT_DT = 30.0


def time_grid_variants(ck, costs, smi, device):
    """Three timed launches (CUDA events, after an untimed one; the median of
    three one-launch samples, each from the start state) of each ``MODE_COLUMNS`` instance of
    ``GRID_VARIANTS`` that the regional paths do not time (all but B1), at
    nz=48 x 32,768 in f32 and f64 (``build_grid_variant``'s columns and
    steps, its dt but ``GRID_TIMED_IMPLICIT_DT`` for the implicit modes),
    beside its bound (a MOST mode's probes from the plain version's launch,
    which is not timed).  Every column's state stays finite in both
    launches, or the phase fails."""
    ncol_of = lambda v: v.shape[-1]  # noqa: E731
    for dtype in (torch.float32, torch.float64):
        for case in GRID_VARIANTS:
            if case == "B1" or case.startswith("cross"):
                continue
            model, Y, stepper, dt, steps = build_grid_variant(GRID_TIMED_NCOL, dtype, device, 12, case,
                                                              nz=GRID_TIMED_NZ)
            dt = GRID_TIMED_IMPLICIT_DT if case.startswith("B4") else dt
            run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=steps)
            states = [_clone(Y) for _ in range(4)]
            run(states[0], 0.0)  # warm: the instance's first launch on the card loads its module
            ms = float(np.median([_time_ms(lambda: run(Yk, 0.0), 1) for Yk in states[1:]]))
            for state in states:
                lost = int(sum((~torch.isfinite(v)).reshape(-1, ncol_of(v)).any(0)
                               for v in state["soil"].values()).count_nonzero())
                if lost:
                    raise AssertionError(f"12 time {run.name}: {lost} columns left the finite numbers")
            probes = most_probes(ck, model, stepper, dt, steps, Y)[1] if run.mode & ck.MODE_MOST else None
            nz, ncol = GRID_TIMED_NZ, GRID_TIMED_NCOL
            b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, nz * ncol, steps, iters=getattr(stepper, "iters", 2),
                                  ncol=ncol, probes=probes, read_values=per_column_values(run, nz, ncol, dtype))
            print(f"[12 time] {str(dtype)[6:]} {run.name} {steps} steps of dt={dt:g} nz={nz} ncol={ncol}: kernel "
                  f"{ms:.3f} ms (median of three launches, {nz * ncol * steps / (ms / 1e3):.4e} grid-points/s; "
                  "every column finite), plain not timed, "
                  f"bound {b_ms:.3f} ms by {b_by} ({b_ms / ms:.3f} of the kernel's time) on {smi}", flush=True)
            del Y, states
        torch.cuda.empty_cache()


# ---- phase 15: the run-file CLI (ROADMAP A16) and the explicit steppers of rk_kernel.cu (ROADMAP B1) ----

RK_STEPPERS = ("ForwardEuler", "SSPRK22", "SSPRK104")
#: 15a: each new instance checked on 1,000 columns over 2 steps
RK_NCOL, RK_STEPS = 1000, 2
#: 15a: each new instance timed at nz=64 x 65,536 over launches of this many steps
RK_TIMED_STEPS = 4
#: 15b: the CLI path's launches of SPC steps, then one more launch resumed
CLI_LAUNCHES, CLI_SAMPLE = 3, 1024
#: 15b: the predicted ms of a 32-step launch at nz=64 x 65,536 (f32 / f64), from B1's time per stage sweep
CLI_PREDICTED = {"SSPRK104": (43.0, 147.0), "SSPRK22": (8.6, 29.0), "ForwardEuler": (4.3, 15.0)}
#: 15c: the order column (nz x ncol), its horizon and coarsest steps, the reference's refinement
ORDER_NZ, ORDER_NCOL, ORDER_HORIZON, ORDER_STEPS, ORDER_REF = 16, 64, 1920.0, 8, 32


def _stepper(name):
    from landhydrology_tpu_torch import timestepping

    return getattr(timestepping, name)()


def rk_cases(dtype, device, ncol):
    """15a's paths: ``(model, start state, dt, steppers, moving fields,
    freeze bars)`` of the coupled variant column (``build_variant_model``)
    in the eight plain-soil modes under the three new steppers, and of the
    water-only and heat-only columns of ``branch_variants`` under them, and
    with lagged coefficients, ``assume_no_ice`` or both under all four."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu_torch.timestepping import SSPRK33

    out = []
    base, Y = build_variant_model(ncol, dtype, device, seed=7)
    for kw in ({}, {"coefficient_update": "step"}, {"assume_no_ice": True},
               {"coefficient_update": "step", "assume_no_ice": True}, {"freeze_thaw": FreezeThaw(tau=60.0)},
               {"coefficient_update": "step", "freeze_thaw": FreezeThaw(tau=60.0)},
               {"freeze_thaw": EquilibriumFreezeThaw()},
               {"coefficient_update": "step", "freeze_thaw": EquilibriumFreezeThaw()}):
        out.append((dataclasses.replace(base, **kw), Y, 5.0, RK_STEPPERS, ("vartheta_l", "rho_e_int"),
                    "freeze_thaw" in kw))
    for model, Yb, stepper, dt, _, _, moving in branch_variants(dtype, device, ncol):
        if not isinstance(stepper, SSPRK33):
            continue
        for kw in ({}, {"coefficient_update": "step"}, {"assume_no_ice": True},
                   {"coefficient_update": "step", "assume_no_ice": True}):
            out.append((dataclasses.replace(model, **kw), Yb, dt, RK_STEPPERS + (("SSPRK33",) if kw else ()),
                        moving, False))
    return out


def rk_check(ck, model, Y0, stepper, dt, moving, freeze):
    """One launch of ``RK_STEPS`` from t0 = 2 s on ``Y0`` against the plain
    version (``check_variant``: ``_check``, or the freeze bars, and
    ``_check_increment``), then the same launch as a B9 forward (start
    tensors that require grad), its launch counted under ``B9:<mode>`` and
    its output equal bit for bit to the kernel's.  Returns ``(name, error,
    shares)``."""
    dtype = model.float_dtype
    check = (lambda a, b, d, w: _check_freeze(a, b, model, d, w)) if freeze else _check
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=RK_STEPS)
    kern, plain, shares = check_variant(ck, model, _clone(Y0), dt, RK_STEPS, 2.0, f"15a {run.name}", moving,
                                        stepper=stepper, check=check)
    b9 = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=RK_STEPS, differentiable=True)
    start = {k: v.clone().requires_grad_(True) for k, v in Y0["soil"].items()}
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    out = b9({"soil": start}, 2.0)["soil"]
    torch.cuda.synchronize()
    if dict(ck.LAUNCHES) != {b9.name: 1}:
        raise AssertionError(f"15a {b9.name}: launches {dict(ck.LAUNCHES)}")
    for k, v in out.items():
        if not np.array_equal(v.detach().double().cpu().numpy(), kern[k]):
            raise AssertionError(f"15a {b9.name}: the B9 forward differs from the kernel's launch in {k}")
    return run.name, _max_abs(kern, plain), shares


#: 15a's B4 twin of the icy check: the implicit steppers' no-ice instances at this dt
ICY_IMPLICIT_DT = 60.0


def rk_icy(ck, dtype, device):
    """15a: the no-ice instances on ``icy_state`` of the variant column
    (``RK_NCOL`` columns, ``RK_STEPS`` steps from t0 = 2 s), each held to its
    plain version (``check_variant``): the rk instances (stage and lagged
    coefficients, 5 s), ``column_kernel.cu``'s B1-no-ice (SSPRK33, 5 s) and
    ``implicit_kernel.cu``'s B4-trbdf2-no-ice, B4-be-soil-no-ice and
    B4-be-richards-no-ice (iters=2, ``ICY_IMPLICIT_DT``), which cap theta_l
    at nu - theta_i as the plain version does (``MODE_RHS_CAP``; ROADMAP C,
    repaired)."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    base, Y = build_variant_model(RK_NCOL, dtype, device, seed=7)
    Y = icy_state(base, Y)
    held = []
    no_ice = dataclasses.replace(base, assume_no_ice=True)
    cases = [(dataclasses.replace(base, **kw), _stepper(name), 5.0)
             for kw in ({"assume_no_ice": True}, {"assume_no_ice": True, "coefficient_update": "step"})
             for name in RK_STEPPERS]
    cases += [(no_ice, SSPRK33(), 5.0)] + [
        (no_ice, implicit(name, no_ice, 2), ICY_IMPLICIT_DT)
        for name in ("TRBDF2Soil", "BackwardEulerSoil", "BackwardEulerRichards")]
    for model, st, dt in cases:
        run_name = ck.make_fused_column_run(model, st).name
        kern, plain, shares = check_variant(ck, model, _clone(Y), dt, RK_STEPS, 2.0, f"15a icy {run_name}",
                                            ("vartheta_l", "rho_e_int"), stepper=st)
        held.append(f"{run_name} {_max_abs(kern, plain):.2e} ({_fmt(shares)})")
    print(f"[15a icy] {str(dtype)[6:]} no ice on an icy state (theta_i 0.05, vartheta_l = nu - 0.02 in the lower "
          f"half), {RK_NCOL} columns, {RK_STEPS} steps: kernel vs plain max abs, change error / largest change (bar "
          f"{INCREMENT_RTOL[dtype]:g}): " + "; ".join(held), flush=True)


def rk_timed_paths(gc, dtype, device):
    """15a's timed paths at nz=64 x 65,536: ``(model, start state, dt,
    stepper names)`` of each mode on the column its SSPRK33
    instance runs at width (phases 4, 5, 8, 9): ``bench.py::build``'s
    (B1-no-ice, B2, B2-no-ice at ``DT``), the freeze column (B3-rate,
    B3-eq, each lagged; its dt), the stiff water-only column at ``dt_exp``
    and the heat-only column at 10 s, each branch alone and with lagged
    coefficients, ``assume_no_ice`` or both; the new steppers, and SSPRK33
    on the branch-policy modes (not B1@: 15b times those).  Every dt is
    under half of ``explicit_dt_limit`` (SSPRK33's extent 2.5), so under
    0.625 of ForwardEuler's and SSPRK22's limits."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw

    bench, Y, _ = build_bench_model(NZ, NCOL, dtype, device)
    for kw in ({"assume_no_ice": True}, {"coefficient_update": "step"},
               {"coefficient_update": "step", "assume_no_ice": True}):
        yield dataclasses.replace(bench, **kw), Y, DT, RK_STEPPERS
    del bench, Y
    for freeze in (FreezeThaw(tau=60.0), EquilibriumFreezeThaw()):
        model, Y, _, dt = build_freeze_wide(gc, dtype, device, freeze)
        for kw in ({}, {"coefficient_update": "step"}):
            yield dataclasses.replace(model, **kw), Y, dt, RK_STEPPERS
        del model, Y
    stiff, Ys, _ = build_stiff(NZ, NCOL, dtype, device)
    heat, Yh, _ = build_heat_only(NZ, NCOL, dtype, device, seed=5)
    for model, Y, dt in ((stiff, Ys, stiff_dt_explicit(stiff, Ys)), (heat, Yh, 10.0)):
        for kw in ({}, {"coefficient_update": "step"}, {"assume_no_ice": True},
                   {"coefficient_update": "step", "assume_no_ice": True}):
            yield dataclasses.replace(model, **kw), Y, dt, RK_STEPPERS + (("SSPRK33",) if kw else ())


def time_rk(ck, costs, smi, model, Y0, dt, stepper, err):
    """One 15a instance at nz=64 x 65,536, ``RK_TIMED_STEPS`` steps per
    launch from t0 = 0 (CUDA events): the kernel x3 twice after an untimed
    launch, the plain version once (one sample); the kernel's state finite
    after every launch (the instance is held to its plain version on
    ``RK_NCOL`` columns).  Returns the kernel record."""
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=RK_TIMED_STEPS)
    Yk = _clone(Y0)
    run(Yk, 0.0)
    k1 = _time_ms(lambda: run(Yk, 0.0), 3)
    k2 = _time_ms(lambda: run(Yk, 0.0), 3)
    p1 = _time_ms(lambda: ck.fused_column_run_plain(model, stepper, dt, RK_TIMED_STEPS, Y0, 0.0), 1)
    if not all(bool(torch.isfinite(v).all()) for v in Yk["soil"].values()):
        raise AssertionError(f"15a {run.name} at nz={NZ} x {NCOL}: the state left the finite numbers")
    return time_record(ck, costs, smi, model, Y0, dt, RK_TIMED_STEPS, stepper, 1, err, (k1, k2), (p1,), None,
                       tag="15a time")


def rk_phase(ck, costs, smi, device, t_start):
    """15a: every new (stepper, mode) instance checked (``rk_check``) on
    ``RK_NCOL`` columns in f64 and f32, the no-ice ones also on an icy
    state (``rk_icy``), then each but the coupled B1 instances (15b times
    those at full width) timed at nz=64 x 65,536 (``rk_timed_paths``,
    ``time_rk``).  Returns the kernel records."""
    gc = _load_golden_config()
    entries = []
    for dtype in (torch.float64, torch.float32):
        results = {}
        for model, Y, dt, steppers, moving, freeze in rk_cases(dtype, device, RK_NCOL):
            for name in steppers:
                results[(id(model), name)] = rk_check(ck, model, Y, _stepper(name), dt, moving, freeze)
        print(f"[15a rk] {str(dtype)[6:]} {len(results)} instances on {RK_NCOL} columns, {RK_STEPS} steps: kernel "
              f"vs plain max abs, change error / largest change (bar {INCREMENT_RTOL[dtype]:g}); each B9 forward = "
              "the launch bit for bit: " + "; ".join(
                  f"{n} {e:.2e} ({_fmt(sh)})" for n, e, sh in results.values()), flush=True)
        rk_icy(ck, dtype, device)
        _mark(t_start, f"phase 15a's {str(dtype)[6:]} checks")
        errors = {n: e for n, e, _ in results.values()}
        for model, Y, dt, steppers in rk_timed_paths(gc, dtype, device):
            for name in steppers:
                st = _stepper(name)
                err = errors[ck.make_fused_column_run(model, st).name]
                entries.append(time_rk(ck, costs, smi, model, Y, dt, st, err))
        torch.cuda.empty_cache()
        _mark(t_start, f"phase 15a's {str(dtype)[6:]} times")
    return entries


def _start_cli(path):
    """``python -m landhydrology_tpu_torch run <path>`` started in a
    subprocess from the checkout (``_finish_cli`` waits for it)."""
    return subprocess.Popen([sys.executable, "-m", "landhydrology_tpu_torch", "run", path], cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_cli(proc, what):
    """``(stdout, kernel launches, host seconds of the run)`` of a CLI run
    that ``_start_cli`` started, once it has exited 0."""
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: the CLI exited {proc.returncode}\n{stdout}\n{stderr}")
    launches = json.loads(stdout.split("kernel launches: ", 1)[1].splitlines()[0])
    wall = float(re.search(r"cells in ([0-9.e+-]+) s \(host clock\)", stdout).group(1))
    return stdout, launches, wall


#: the ``CliRuns`` started so far: ``_quiet`` waits for them before a kernel is timed
_BACKGROUND = []


def _quiet():
    """Wait for every ``CliRuns`` started so far: no CLI run of theirs shares
    the card with a timed launch (CUDA events; the card time-slices between
    processes)."""
    for runs in _BACKGROUND:
        runs.join()


class CliRuns(threading.Thread):
    """``_start_cli`` and ``_finish_cli`` of each of ``paths``, in a thread
    started at once, beside the caller's other work: in turn (each after the
    one before: a run file may resume from another's checkpoint), or with
    ``together`` all started before the first is waited for (each CLI spends
    most of its time starting up); ``results`` waits for the thread and
    returns their ``(stdout, kernel launches, host seconds)`` in the order
    of ``paths``, or raises the first failure."""

    def __init__(self, paths, what, together=False):
        super().__init__()
        self.paths, self.what, self.together, self.out, self.error = list(paths), what, together, [], None
        _BACKGROUND.append(self)
        self.start()

    def run(self):
        try:
            if self.together:
                procs = [_start_cli(path) for path in self.paths]
                self.out = [_finish_cli(proc, self.what) for proc in procs]
            else:
                for path in self.paths:
                    self.out.append(_finish_cli(_start_cli(path), self.what))
        except BaseException as error:  # raised by results
            self.error = error

    def results(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.out


class CliAhead:
    """15b's and 18b's run-file CLIs for ``main``: their files
    (``cli_run_files``, ``land_cli_files``) in a temporary directory, their
    runs started together (``start``: 15b's A then B, beside 18b's two)
    before 17a's checks, which run while they start up, and checked after
    the first float type's (``check``); their times stay in phases 15 and 18
    (``cli_times``, ``land_cli_times``).  A CLI spends most of its time
    (about 8 s on the card's host) starting up, which costs nothing beside
    17a's checks; a run of theirs shares the card with checks, never with a
    timed launch (``_quiet``)."""

    def __init__(self, device, seed):
        import tempfile

        self.workdir = tempfile.TemporaryDirectory()
        self.spec = cli_run_files(device, seed, self.workdir.name)
        self.land_files, self.land_dts = land_cli_files(device, self.workdir.name)
        self.kernel_ms, self.runs, self.land_runs = None, None, None

    def start(self):
        files = self.spec["files"]
        self.runs = CliRuns([files["A"], files["B"]], "15b")
        self.land_runs = CliRuns([path for path, _ in self.land_files.values()], "18b", together=True)

    def check(self, ck, costs, smi, device):
        """15b's and 18b's checks of the runs (``cli_check``, ``cli_summary``
        with 15b's times, ``land_cli_check``); removes the directory.
        Returns 18b's kernel records."""
        try:
            ran = cli_check(ck, device, self.spec, self.runs)
            cli_summary(smi, self.spec, ran, self.kernel_ms)
            return land_cli_check(ck, costs, smi, device, self.land_files, self.land_dts, self.land_runs)
        finally:
            self.workdir.cleanup()


def cli_model(dtype, device, seed):
    """``bench.py::build``'s model at nz=64 x 65,536 with Ksat drawn per
    column from ``seed``: 0.5-2x bench.py's value, in ``dtype``."""
    model, _, _ = build_bench_model(NZ, NCOL, dtype, device)
    hm = model.hydrology_model.hydraulic_model
    Ksat = torch.as_tensor(hm.Ksat * np.random.default_rng(seed).uniform(0.5, 2.0, NCOL), dtype=dtype, device=device)
    return dataclasses.replace(model, hydrology_model=dataclasses.replace(
        model.hydrology_model, hydraulic_model=dataclasses.replace(hm, Ksat=Ksat)))


def cli_run_files(device, seed, workdir):
    """15b's run files in ``workdir``: ``cli_model`` (f64) written by
    ``to_config`` with hydrostatic initial conditions (z_table -1 m, 288 K),
    SSPRK104 and ``"engine": "pallas"``: A, 96 steps in 3 launches saved at
    each, with a checkpoint; B, the same to 128 steps.  dt is the largest
    power of two under half of ``explicit_dt_limit`` (which assumes
    SSPRK33's real-axis extent 2.5): under 0.625 of ForwardEuler's and
    SSPRK22's limits (extent 2) and far under SSPRK104's.  Returns
    ``{"files", "outs", "cfg", "dt", "n_cli"}`` for ``cli_check`` and
    ``cli_times``."""
    from landhydrology_tpu_torch import cli
    from landhydrology_tpu_torch.config import to_config
    from landhydrology_tpu_torch.diagnostics import explicit_dt_limit

    model = cli_model(torch.float64, device, seed)
    files = {k: os.path.join(workdir, f"run_{k}.json") for k in "AB"}
    outs = {k: os.path.join(workdir, f"out_{k}.npz") for k in "AB"}
    ckpt = os.path.join(workdir, "checkpoints")
    cfg = {"model": to_config(model),
           "simulation": {"dt": 1.0, "t_final": 1.0, "stepper": "SSPRK104", "engine": "pallas",
                          "steps_per_call": SPC},
           "initial_conditions": {"kind": "hydrostatic", "z_table": -1.0, "T": 288.0}}
    with open(files["A"], "w") as f:
        json.dump(cfg, f)
    run_model, _, Y_ic, _, _, _ = cli.load_run(files["A"], device)
    limit = float(explicit_dt_limit(run_model, Y_ic))
    dt = 2.0 ** math.floor(math.log2(0.5 * limit))
    n_cli = CLI_LAUNCHES * SPC
    for key, t_final in (("A", n_cli * dt), ("B", (n_cli + SPC) * dt)):
        c = dict(cfg, output={"path": outs[key]}, checkpoint={"directory": ckpt})
        c["simulation"] = dict(cfg["simulation"], dt=dt, t_final=t_final, saveat=SPC * dt)
        with open(files[key], "w") as f:
            json.dump(c, f)
    print(f"[15b cli] run files at nz={NZ} x {NCOL} (Ksat per column from seed {seed}), hydrostatic z_table -1.0 m, "
          f"288 K, SSPRK104, engine pallas: explicit_dt_limit {limit:.6g} s, dt {dt!r} s", flush=True)
    return {"files": files, "outs": outs, "cfg": cfg, "dt": dt, "n_cli": n_cli}


def cli_check(ck, device, spec, runs):
    """15b's checks of the CLI runs ``runs`` (``CliRuns`` of
    ``cli_run_files``' A then B): A launches 3 times, B once, resumed from
    A's checkpoint; a straight 128-step run of the file's model and state
    (``Simulation``, in this process; the CLI builds the same run) equals
    B's state bit for bit, A's checkpoint its state at step 96, and its
    first launch on every 64th column (1,024) meets the plain version's 32
    steps.  Returns ``{file: (kernel launches, host seconds)}``."""
    from landhydrology_tpu_torch import Simulation, cli

    files, outs, dt, n_cli = spec["files"], spec["outs"], spec["dt"], spec["n_cli"]
    ran = {}
    for key, (out, launches, wall) in zip("AB", runs.results()):
        what, expect = {"A": ("96 steps with a checkpoint", CLI_LAUNCHES), "B": ("resumed", 1)}[key]
        if launches != {"B1@SSPRK104": expect}:
            raise AssertionError(f"15b {what}: launches {launches}, expected {expect} of B1@SSPRK104")
        if key == "B" and f"resumed from checkpoint step {n_cli}" not in out:
            raise AssertionError(f"15b {what}: did not resume from step {n_cli}:\n{out}")
        ran[key] = (launches, wall)
        print(f"[15b cli] {what}: python -m landhydrology_tpu_torch run: kernel launches {launches}, Simulation.run "
              f"{wall:.6f} s host clock", flush=True)
    run_model, _, Y_ic, _, _, _ = cli.load_run(files["A"], device)
    sim = Simulation(run_model, _stepper("SSPRK104"), Y_init=Y_ic, dt=dt, tspan=(0.0, (n_cli + SPC) * dt),
                     saveat=SPC * dt, engine="fused", steps_per_call=SPC)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    t_wall = time.perf_counter()
    sol = sim.run()
    torch.cuda.synchronize()
    straight_wall = time.perf_counter() - t_wall
    if dict(ck.LAUNCHES) != {"B1@SSPRK104": CLI_LAUNCHES + 1}:
        raise AssertionError(f"15b straight run: launches {dict(ck.LAUNCHES)}")
    fields = ("vartheta_l", "theta_i", "rho_e_int")
    data = {k: np.load(outs[k]) for k in "AB"}
    data["straight"] = {k: sol.us["soil"][k].cpu().numpy() for k in fields}
    del sol, sim
    saves = {k: len(data[k]["vartheta_l"]) for k in data}
    if saves != {"A": CLI_LAUNCHES + 1, "B": 2, "straight": CLI_LAUNCHES + 2}:
        raise AssertionError(f"15b: saves {saves}")
    for k in fields:
        if not np.array_equal(data["B"][k][-1], data["straight"][k][-1]):
            raise AssertionError(f"15b: the resumed run differs from the straight run in {k}")
        if not (np.array_equal(data["B"][k][0], data["A"][k][-1])
                and np.array_equal(data["A"][k][-1], data["straight"][k][-2])):
            raise AssertionError(f"15b: the checkpoint's {k} is not the straight run's state at step {n_cli}")
    print(f"[15b cli] straight {n_cli + SPC} steps (Simulation in this process): kernel launches "
          f"{{'B1@SSPRK104': {CLI_LAUNCHES + 1}}}, Simulation.run {straight_wall:.6f} s host clock", flush=True)
    # the plain version on every 64th column of the straight run's first launch (its other launches are the
    # same instance from the state the first leaves; a cut for the script's time)
    idx = torch.arange(0, NCOL, NCOL // CLI_SAMPLE, device=device)
    sub, Yp = column_slice(run_model, Y_ic, idx)
    start = _np(Yp)
    Yp = ck.fused_column_run_plain(sub, _stepper("SSPRK104"), dt, SPC, Yp, 0.0)
    kern = {k: data["straight"][k][1][:, idx.cpu().numpy()] for k in fields}
    plain = _np(Yp)
    _check(kern, plain, torch.float64, "15b straight run vs plain")
    shares = _check_increment(kern, plain, start, torch.float64, "15b straight run vs plain", ("vartheta_l",))
    err = _max_abs(kern, plain)
    print(f"[15b cli] resumed run = straight run bit for bit; checkpoint = the straight run at step {n_cli}; "
          f"{CLI_SAMPLE} columns of the straight run's first launch vs plain max abs {err:.3e}, change error / largest "
          f"change {_fmt(shares)} (bar {INCREMENT_RTOL[torch.float64]:g})", flush=True)
    return ran


def cli_times(ck, costs, smi, device, seed, spec):
    """15b's times: one 32-step launch of each explicit stepper at the run
    files' width and dt in f32 and f64 (kernel x3 twice, CUDA events; the
    plain version once but for SSPRK33), the kernel checked against the
    plain version on its start state.  The f64 SSPRK104 record counts the
    CLI's ``CLI_LAUNCHES`` launches (which ``cli_check`` holds), the others
    this check's launch.  Returns ``(the kernel records of B1@ForwardEuler,
    B1@SSPRK22, B1@SSPRK104, {(dtype, stepper): kernel ms})``."""
    from landhydrology_tpu_torch import cli

    dt = spec["dt"]
    entries, kernel_ms = [], {}
    for dtype in (torch.float32, torch.float64):
        m = cli_model(dtype, device, seed)
        Y0, _ = cli._build_ic(m, spec["cfg"]["initial_conditions"])
        for name in RK_STEPPERS + ("SSPRK33",):
            st = _stepper(name)
            run = ck.make_fused_column_run(m, st, dt=dt, steps_per_call=SPC)
            Yk = _clone(Y0)
            torch.cuda.synchronize()
            ck.LAUNCHES.clear()
            run(Yk, 0.0)
            torch.cuda.synchronize()
            if dict(ck.LAUNCHES) != {run.name: 1}:
                raise AssertionError(f"15b {run.name}: launches {dict(ck.LAUNCHES)}")
            got = _np(Yk)
            k1, k2 = _time_ms(lambda: run(Yk, 0.0), 3), _time_ms(lambda: run(Yk, 0.0), 3)
            kernel_ms[(dtype, name)] = (k1 + k2) / 2
            if name == "SSPRK33":
                print(f"[15b time] {str(dtype)[6:]} {run.name} {SPC} steps nz={NZ} ncol={NCOL}: kernel {k1:.3f}/"
                      f"{k2:.3f} ms ({NZ * NCOL * SPC / ((k1 + k2) / 2e3):.4e} grid-points/s) on {smi}", flush=True)
                continue
            plain = []
            p1 = _time_ms(lambda: plain.append(ck.fused_column_run_plain(m, st, dt, SPC, Y0, 0.0)), 1)
            ref = _np(plain.pop())
            _check(got, ref, dtype, f"15b {run.name}")
            _check_increment(got, ref, _np(Y0), dtype, f"15b {run.name}", ("vartheta_l",))
            # the CLI path's launches for its instance, this check's launch for the others
            launches = CLI_LAUNCHES if dtype == torch.float64 and name == "SSPRK104" else 1
            entries.append(time_record(ck, costs, smi, m, Y0, dt, SPC, st, launches, _max_abs(got, ref), (k1, k2),
                                       (p1,), None, tag="15b time"))
            del plain, ref, got
        del Y0
        torch.cuda.empty_cache()
    return entries, kernel_ms


def cli_summary(smi, spec, ran, kernel_ms):
    """15b's line on the CLI's run A: its rate end to end, the kernel's
    share of it, and each stepper's kernel time against its prediction."""
    wall = ran["A"][1]
    busy = CLI_LAUNCHES * kernel_ms[(torch.float64, "SSPRK104")] / 1e3
    print(f"[15b cli] the CLI's run A: {NZ * NCOL * spec['n_cli'] / wall:.4e} grid-points/s end to end (host clock), "
          f"kernel {busy:.6f} s of {wall:.6f} s, host share {1 - busy / wall:.4f}; per 32-step launch measured "
          "(predicted) ms: " + "; ".join(
              f"{n} " + ", ".join(f"{str(d)[6:]} {kernel_ms[(d, n)]:.3f} ({CLI_PREDICTED[n][i]:g})"
                                  for i, d in enumerate((torch.float32, torch.float64))) for n in CLI_PREDICTED)
          + "; SSPRK33 (B1) " + ", ".join(f"{str(d)[6:]} {kernel_ms[(d, 'SSPRK33')]:.3f}"
                                          for d in (torch.float32, torch.float64)) + f" on {smi}", flush=True)


def cli_phase(ck, costs, smi, device, seed, workdir):
    """15b: ``cli_run_files``' files run by ``python -m
    landhydrology_tpu_torch run`` (A, then B resumed from A's checkpoint;
    ``CliRuns``) and checked (``cli_check``), then each explicit stepper
    timed at their width (``cli_times``).  ``main`` runs the CLI beside
    17a's checks instead (``CliAhead``).  Returns the kernel records of
    B1@ForwardEuler, B1@SSPRK22, B1@SSPRK104."""
    spec = cli_run_files(device, seed, workdir)
    ran = cli_check(ck, device, spec, CliRuns([spec["files"]["A"], spec["files"]["B"]], "15b"))
    entries, kernel_ms = cli_times(ck, costs, smi, device, seed, spec)
    cli_summary(smi, spec, ran, kernel_ms)
    return entries


def order_model(device):
    """15c's column: the benchmark soil at nz=16 x 64 in f64 under a
    time-varying flux top (callables, so the tables hold every stage time):
    rain of 2e-6 (1 + sin(2 pi t / 1,920 s)) m/s and an energy flux of
    40 sin(2 pi t / 960 s) W/m^2."""
    from landhydrology_tpu_torch import SoilColumnBC, SoilComponentBC, VerticalFlux

    model, Y, _ = build_bench_model(ORDER_NZ, ORDER_NCOL, torch.float64, device)
    w = 2.0 * math.pi / ORDER_HORIZON
    top = SoilComponentBC(hydrology=VerticalFlux(lambda t: -2e-6 * (1.0 + torch.sin(w * t))),
                          energy=VerticalFlux(lambda t: 40.0 * torch.sin(2.0 * w * t)))
    model = dataclasses.replace(model, boundary_conditions=SoilColumnBC(
        top=top, bottom=model.boundary_conditions.bottom))
    return model, Y


def order_phase(ck, device):
    """15c: each explicit stepper through its kernel (B1@...) over
    ``ORDER_HORIZON`` at ``ORDER_STEPS``, twice and four times as many steps
    (one launch each), against SSPRK104 at ``ORDER_REF`` times the finest
    steps (one launch): the error (the largest deviation over the fields,
    each over its largest value) falls by 2^p per halving, the last slope
    within 0.35 of p = 1, 2, 3, 4, each error above 1e-10."""
    model, Y0 = order_model(device)
    fields = ("vartheta_l", "rho_e_int")

    def solve(name, n):
        run = ck.make_fused_column_run(model, _stepper(name), dt=ORDER_HORIZON / n, steps_per_call=n)
        Y = _clone(Y0)
        ck.LAUNCHES.clear()
        run(Y, 0.0)
        torch.cuda.synchronize()
        if dict(ck.LAUNCHES) != {run.name: 1}:
            raise AssertionError(f"15c {run.name}: launches {dict(ck.LAUNCHES)}")
        return _np(Y)

    ref = solve("SSPRK104", 4 * ORDER_STEPS * ORDER_REF)
    lines = []
    for p, name in enumerate(("ForwardEuler", "SSPRK22", "SSPRK33", "SSPRK104"), start=1):
        errs = []
        for n in (ORDER_STEPS, 2 * ORDER_STEPS, 4 * ORDER_STEPS):
            got = solve(name, n)
            errs.append(max(float(np.max(np.abs(got[k] - ref[k]))) / float(np.max(np.abs(ref[k]))) for k in fields))
        slopes = [math.log2(errs[i] / errs[i + 1]) for i in range(2)]
        if not (abs(slopes[-1] - p) < 0.35 and min(errs) > 1e-10):
            raise AssertionError(f"15c {name}: errors {errs}, slopes {slopes}, expected order {p}")
        lines.append(f"{name} errors {', '.join(f'{e:.3e}' for e in errs)}, slopes {slopes[0]:.3f} {slopes[1]:.3f} "
                     f"(order {p})")
    print(f"[15c order] f64 nz={ORDER_NZ} x {ORDER_NCOL}, time-varying flux top, {ORDER_HORIZON:g} s in "
          f"{ORDER_STEPS}, {2 * ORDER_STEPS}, {4 * ORDER_STEPS} steps against SSPRK104 in "
          f"{4 * ORDER_STEPS * ORDER_REF}: " + "; ".join(lines), flush=True)


def cli_main(ck, costs, smi, device, seed, t_start, ahead=None):
    """Phase 15: 15a (``rk_phase``), 15b (``cli_phase``, in a temporary
    directory removed at its end; with ``ahead``, a ``CliAhead``, its times
    alone, ``cli_times``: ``main`` runs and checks its CLI beside 17a),
    15c (``order_phase``).  Returns the kernel records."""
    import tempfile

    entries = rk_phase(ck, costs, smi, device, t_start)
    _mark(t_start, "phase 15a")
    if ahead is not None:
        records, ahead.kernel_ms = cli_times(ck, costs, smi, device, seed, ahead.spec)
        entries += records
    else:
        with tempfile.TemporaryDirectory() as workdir:
            entries += cli_phase(ck, costs, smi, device, seed, workdir)
    _mark(t_start, "phase 15b")
    order_phase(ck, device)
    return entries


# ---- phase 13: adaptive stepping (ROADMAP A15), kernel modes B1-dt and B4+B5(+B7) ----

#: phase 13a replays this many iterations of each kernel-driven run through
#: the plain version on the card (the eager closures take most of the phase;
#: two iterations chain six launches, each at its own dt_run)
ADAPTIVE_PLAIN_ITERS = 2
#: phase 13b launches every mode at this share of its factory dt, on this many columns
DT_RUN_SHARE, DT_RUN_NCOL = 0.37, 1000
#: the plain version's check of the full-width adaptive runs takes this many evenly spaced columns
ADAPTIVE_SAMPLE = 1024
#: the fixed-dt reference of a full-width adaptive run steps at the largest
#: accepted dt over this
FINE_DIVISOR = 8
#: phase 13c's forced runs take the first rows of the reanalysis window as
#: their time-indexed table: under the default tolerances the LandModel's
#: pond and rain front hold dt at 1-9 s, 987 segments (361 s in f64 on one
#: H100) over the window's 240 rows
ADAPTIVE_FORCED_ROWS = 12
#: phase 13's timings of the B4+B5 modes: the reanalysis soil at a quarter
#: width (the plain version's launches take seconds there), this many steps per launch
B4_B5_TIMED_NCOL, B4_B5_TIMED_STEPS = 32768, 4


def adaptive_replay_plain(ck, model, Y0, stepper, spc, records, config, forcing=None, forcing_dt=None):
    """The plain version on the card replaying a kernel-driven run's
    iteration ``records`` (the same steps and decisions) under ``config``:
    ``(state, log)``."""
    from landhydrology_tpu_torch import adaptive

    grid = None
    if forcing is not None:
        grid = (0.0, float(forcing_dt), next(iter(forcing.values())).shape[0])
    segment = lambda Y, t, dt: ck.fused_column_run_plain(  # noqa: E731
        model, stepper, float(dt), spc, Y, t, forcing=forcing, forcing_time_grid=grid)
    log = []
    Y, _ = adaptive._drive(segment, Y0, 0.0, records[-1][0] + spc * records[-1][1], records[0][1],
                           adaptive._with_exponents(config, stepper), model.float_dtype, spc, log=log,
                           replay=records)
    return Y, log


def adaptive_small(ck, gc, device):
    """Phase 13a, f64 at the JAX tests' sizes through the kernels: the
    adaptive golden's case a (run_adaptive_fused, B1) and case b
    (run_adaptive_forced(engine="fused"), TR-BDF2 under a MOST top with
    time-indexed rows, B4-trbdf2+B5+B7-time), each free and against the
    golden's bars (``check_adaptive_run``), case b also replaying the
    golden's iteration records (``check_adaptive_replay``); then every JAX
    test of ``ADAPTIVE_TESTS`` replaying its records (error norms, decisions,
    final state at rtol 1e-10, TR-BDF2 1e-9) and free (the counts of JAX's
    run); the first ``ADAPTIVE_PLAIN_ITERS`` iterations of each kernel-driven
    free run replayed through the kernel and the plain version on the card
    (the states at ``_check``'s bars, the error norms within the noise
    bar)."""
    from landhydrology_tpu_torch.adaptive import run_adaptive_forced, run_adaptive_fused

    f64 = torch.float64
    golden = np.load(os.path.join(HERE, "tests", "data", "golden_adaptive_f64.npz"))

    def kernel_run(driver, model, Y, Ya, stepper, kw, what, replay=None):
        log = []
        torch.cuda.synchronize()
        ck.LAUNCHES.clear()
        Yf, stats = driver(model, Y, Ya, 0.0, stepper=stepper, log=log, replay=replay, **kw)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        if sum(launches.values()) != 3 * len(log) or len(launches) != 1:
            raise AssertionError(f"13 adaptive {what}: launches {launches} for {len(log)} iterations")
        return Yf, stats, log, launches

    def against_plain(driver, model, Y, Ya, stepper, kw, log, what):
        """The kernel-driven run's first ``ADAPTIVE_PLAIN_ITERS`` iterations
        replayed through the kernel and through the plain version on the
        card: the states at ``_check``'s bars, the error norms within the
        noise bar."""
        records = log[:ADAPTIVE_PLAIN_ITERS]
        Yk, _, klog, _ = kernel_run(driver, model, Y, Ya, stepper, kw, f"{what} prefix", replay=records)
        forcing = kw.get("forcing")
        if forcing is not None:
            forcing = {k: torch.as_tensor(v, dtype=f64, device=device) for k, v in forcing.items()}
        Yp, plog = adaptive_replay_plain(ck, model, Y, stepper, kw.get("steps_per_call", 1), records, kw["config"],
                                         forcing, kw.get("forcing_dt"))
        kern, plain = _np(Yk), _np(Yp)
        _check(kern, plain, f64, f"13 adaptive {what} vs plain")
        ratio = gc.check_replay_errors(klog, plog, kw["config"].rtol, f"13 adaptive {what} plain replay")
        return f"kernel vs plain over its first {len(records)} iterations (the same steps): max abs " \
               f"{_max_abs(kern, plain):.3e}, error norms within {ratio:.3f} of the noise bar"

    def fmt(held):
        return "; ".join(f"{k} {v[0]:.3e} (bar {v[1]:.3e})" for k, v in held.items())

    t_case = time.perf_counter()
    model, Y, Ya, st, kw = gc.build_adaptive_case("a", f64, device)
    Yf, stats, log, launches = kernel_run(run_adaptive_fused, model, Y, Ya, st, kw, "golden a")
    kern = _np(Yf)
    held = gc.check_adaptive_run(golden, "a", stats, kern, log)
    line = against_plain(run_adaptive_fused, model, Y, Ya, st, kw, log, "golden a")
    print(f"[13 adaptive] f64 {launches} golden case a (run_adaptive_fused, SSPRK33, 4 steps per segment, "
          f"{int(stats['n_accepted'])} accepted, {int(stats['n_rejected'])} rejected, dt_final "
          f"{float(stats['dt_final'])!r}) vs golden_adaptive_f64.npz: {fmt(held)}; {line}; "
          f"{time.perf_counter() - t_case:.1f} s", flush=True)

    t_case = time.perf_counter()
    model, Y, Ya, st, kw = gc.build_adaptive_case("b", f64, device)
    kw = dict(kw, engine="fused", steps_per_call=1)
    Yf, stats, log, launches = kernel_run(run_adaptive_forced, model, Y, Ya, st, kw, "golden b")
    kern = _np(Yf)
    held = gc.check_adaptive_run(golden, "b", stats, kern, log)
    line = against_plain(run_adaptive_forced, model, Y, Ya, st, kw, log, "golden b")
    Yr, _, rlog, _ = kernel_run(run_adaptive_forced, model, Y, Ya, st, kw, "golden b replay",
                                replay=gc.golden_records(golden, "b"))
    ratio, dev = gc.check_adaptive_replay(golden, rlog, _np(Yr))
    print(f"[13 adaptive] f64 {launches} golden case b (run_adaptive_forced(engine='fused'), TRBDF2Soil(iters=2), "
          f"time-indexed rows; {int(stats['n_accepted'])} accepted, {int(stats['n_rejected'])} rejected, "
          f"dt_final {float(stats['dt_final'])!r}; the golden {int(golden['b_n_accepted'])}, "
          f"{int(golden['b_n_rejected'])}) vs golden_adaptive_f64.npz: {fmt(held)}; replaying the golden's "
          f"{len(rlog)} iterations: error norms within {ratio:.3f} of the noise bar, final state {dev:.3e} "
          f"(bar 1e-10); {line}; {time.perf_counter() - t_case:.1f} s", flush=True)

    for name in gc.ADAPTIVE_TESTS:
        t_case = time.perf_counter()
        model, Y, Ya, st, kw = gc.build_adaptive_test(name, f64, device)
        rtol = 1e-9 if gc.ADAPTIVE_TESTS[name].get("trbdf2") else 1e-10
        ref = gc.golden_state(golden, name, "replay")
        Yr, _, rlog, launches = kernel_run(run_adaptive_fused, model, Y, Ya, st, kw, f"{name} replay",
                                           replay=gc.golden_records(golden, name))
        ratio = gc.check_replay_errors(gc.golden_records(golden, name), rlog, kw["config"].rtol,
                                       f"13 adaptive {name} replay")
        for group, fields in ref.items():
            for k, v in fields.items():
                np.testing.assert_allclose(Yr[group][k].cpu().numpy(), v, rtol=rtol, atol=1e-16,
                                           err_msg=f"13 adaptive {name} replay/{group}/{k}")
        _, stats, log, _ = kernel_run(run_adaptive_fused, model, Y, Ya, st, kw, name)
        counts = (int(stats["n_accepted"]), int(stats["n_rejected"]))
        ref_counts = (int(golden[f"{name}__n_accepted"]), int(golden[f"{name}__n_rejected"]))
        if counts != ref_counts:
            raise AssertionError(f"13 adaptive {name}: counts {counts}, JAX's {ref_counts}")
        line = against_plain(run_adaptive_fused, model, Y, Ya, st, kw, log, name)
        print(f"[13 adaptive] f64 {launches} {name} (steps_per_call={kw['steps_per_call']}): replaying JAX's "
              f"{len(rlog)} iterations, error norms within {ratio:.3f} of the noise bar, final state at rtol "
              f"{rtol:g}; free: {counts[0]} accepted, {counts[1]} rejected (JAX's), dt_final "
              f"{float(stats['dt_final'])!r} (JAX {float(golden[f'{name}__dt_final'])!r}); {line}; "
              f"{time.perf_counter() - t_case:.1f} s", flush=True)


def dt_run_cases(dtype, device):
    """Phase 13b's launches, one per mode of the kernel table on
    ``DT_RUN_NCOL`` columns: ``(model, state, stepper, dt_run, steps, t0,
    rows, time grid, moving fields)``, at the step sizes of phases 3, 10,
    11 and 12.  Each has a time-dependent input (a callable
    BC value, a prescribed profile T(z, t), a callable atmosphere field, a
    rain pulse or time-indexed rows), so a launch at the wrong step size
    reads other values."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu_torch.timestepping import SSPRK33

    coupled = ("vartheta_l", "rho_e_int")
    cases = []
    for kw in ({}, {"assume_no_ice": True}, {"coefficient_update": "step"},
               {"coefficient_update": "step", "assume_no_ice": True}, {"freeze_thaw": FreezeThaw(tau=60.0)},
               {"freeze_thaw": EquilibriumFreezeThaw()},
               {"coefficient_update": "step", "freeze_thaw": FreezeThaw(tau=60.0)},
               {"coefficient_update": "step", "freeze_thaw": EquilibriumFreezeThaw()}):
        model, Y = build_variant_model(DT_RUN_NCOL, dtype, device, seed=7)
        cases.append((dataclasses.replace(model, **kw), Y, SSPRK33(), 5.0, 8, 2.0, None, None, coupled))
    for model, Y, stepper, dt, n, _, moving in branch_variants(dtype, device, DT_RUN_NCOL):
        cases.append((model, Y, stepper, dt, n, 2.0, None, None, moving))
    model, Y = build_variant_model(DT_RUN_NCOL, dtype, device, seed=7)
    for name, tridiag in (("TRBDF2Soil", "thomas"), ("TRBDF2Soil", "pcr"), ("BackwardEulerSoil", "thomas"),
                          ("BackwardEulerRichards", "thomas")):
        cases.append((model, Y, implicit(name, model, 2, tridiag), 60.0, 4, 2.0, None, None, coupled))
    stiff, Ys, _ = build_stiff(16, DT_RUN_NCOL, dtype, device)
    cases.append((stiff, Ys, implicit("BackwardEulerRichards", stiff, 2), 5.0, 4, 2.0, None, None, ("vartheta_l",)))
    land_moving = ("vartheta_l", "rho_e_int", "h_s")
    for case in ("B5", "B2+B5", "B6", "B6-step", "B2+B6", "B2+B6-step", "B6-pond", "B6-step-pond", "B2+B6-pond",
                 "B2+B6-step-pond"):
        m, Yv = build_land_variant(DT_RUN_NCOL, dtype, device, seed=13, case=case)
        cases.append((m, Yv, SSPRK33(), 2.0, 4, 5.0, None, None, land_moving))
    # B7: step-indexed rows, and time-indexed rows on a grid where the
    # factory dt and dt_run read different rows
    for case, time_indexed in (("B5", False), ("B2+B5", True), ("B6", False), ("B6-step", True),
                               ("B2+B6-step-pond", True)):
        m, Yv = build_land_variant(DT_RUN_NCOL, dtype, device, seed=13, case=case)
        n_rows = 5 if time_indexed else 4
        cases.append((m, Yv, SSPRK33(), 2.0, 4, 5.0, variant_rows(m, case, n_rows),
                      (5.5, 1.5, n_rows) if time_indexed else None, land_moving))
    for case in GRID_VARIANTS:
        model, Y, stepper, dt, n = build_grid_variant(DT_RUN_NCOL, dtype, device, 7, case)
        moving = coupled if "rho_e_int" in Y["soil"] else ("vartheta_l",)
        cases.append((model, Y, stepper, dt, n, 2.0, None, None, moving))
    # the implicit steppers under a MOST top (B4+B5), alone and with rows
    soil, Yv = build_land_variant(DT_RUN_NCOL, dtype, device, seed=13, case="B5")
    for name, tridiag in (("TRBDF2Soil", "thomas"), ("TRBDF2Soil", "pcr"), ("BackwardEulerSoil", "thomas"),
                          ("BackwardEulerRichards", "thomas")):
        cases.append((soil, Yv, implicit(name, soil, 2, tridiag), 30.0, 4, 5.0, None, None, coupled))
    for name, time_indexed in (("TRBDF2Soil", False), ("TRBDF2Soil", True), ("BackwardEulerSoil", True),
                               ("BackwardEulerRichards", False)):
        n_rows = 5 if time_indexed else 4
        cases.append((soil, Yv, implicit(name, soil, 2), 30.0, 4, 5.0, variant_rows(soil, "B5", n_rows),
                      (5.5, 20.0, n_rows) if time_indexed else None, coupled))
    return cases


def check_dt_run(ck, model, Y, stepper, dt, n, t0, rows, grid, moving, plain_check=True):
    """One launch at ``dt_run = dt`` (rounded to the model dtype) of a run
    built at ``dt / DT_RUN_SHARE``, with the launch counts set to 0 just
    before it and read just after: equal bit for bit to a launch of a run
    built at that step size, and with ``plain_check`` held to the plain
    version at that step (``_check``, ``_check_increment``).  Returns
    ``(name, max abs error or None, shares)``."""
    dtype = model.float_dtype
    h = float(torch.tensor(dt, dtype=dtype))
    kw = dict(steps_per_call=n, forcing_fields=tuple(rows or ()), forcing_time_grid=grid)
    run = ck.make_fused_column_run(model, stepper, dt=dt / DT_RUN_SHARE, **kw)
    built = ck.make_fused_column_run(model, stepper, dt=h, **kw)
    start = _np(Y)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    kern = _np(run(_clone(Y), t0, forcing=rows, dt_run=h))
    torch.cuda.synchronize()
    if dict(ck.LAUNCHES) != {run.name: 1}:
        raise AssertionError(f"13 dt_run {run.name}: launches {dict(ck.LAUNCHES)}")
    ref = _np(built(_clone(Y), t0, forcing=rows))
    if not all(np.array_equal(kern[k], ref[k], equal_nan=True) for k in ref):
        raise AssertionError(f"13 dt_run {run.name} {str(dtype)[6:]}: the launch at dt_run={h!r} differs from a "
                             f"run built with dt={h!r}")
    if not plain_check:
        return run.name, None, {}
    plain = _np(ck.fused_column_run_plain(model, stepper, h, n, Y, t0, forcing=rows, forcing_time_grid=grid))
    what = f"13 dt_run {str(dtype)[6:]} {run.name}"
    _check(kern, plain, dtype, what)
    shares = _check_increment(kern, plain, start, dtype, what, [k for k in moving if k in kern])
    return run.name, _max_abs(kern, plain), shares


def dt_run_phase(ck, device):
    """Phase 13b: ``check_dt_run`` in every mode of ``dt_run_cases``, f64
    and f32, each launch held bit for bit to a run built at its step, and
    to the plain version at that step only the implicit steppers under MOST
    without rows, whose records carry the error (a cut for the script's
    time since phase 18, in f64 too: every mode's instance meets the plain
    version at its own step in phases 3-18).  Returns the B4+B5 modes'
    records ``{(dtype, name): (launches, max abs error)}``."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        names = []
        for case in dt_run_cases(dtype, device):
            mode = ck.kernel_mode(case[0], case[2])
            held = case[6] is None and mode & ck.MODE_MOST and mode & ck.MODE_IMPLICIT
            name, err, shares = check_dt_run(ck, *case, plain_check=bool(held))
            names.append(name)
            if "+B5" in name and name.startswith("B4") and err is not None:
                out[(dtype, name)] = (1, err)
            plain = ("not held to the plain version" if err is None else
                     f"vs plain max abs {err:.3e}; change error / largest change {_fmt(shares)} "
                     f"(bar {INCREMENT_RTOL[dtype]:g})")
            print(f"[13 dt_run] {str(dtype)[6:]} {name} ncol={DT_RUN_NCOL}: one launch at dt_run = {DT_RUN_SHARE} x "
                  f"the factory dt, equal bit for bit to a run built with that dt; {plain}", flush=True)
        print(f"[13 dt_run] {str(dtype)[6:]}: {len(names)} modes at dt_run: {', '.join(names)}", flush=True)
        torch.cuda.empty_cache()
    return out


def _moving_share(final, ref, start, moving):
    """Per moving field, the largest deviation of ``final`` from ``ref`` over
    the largest change of ``ref`` from ``start``."""
    return {k: float(np.max(np.abs(final[k] - ref[k]))) / (float(np.max(np.abs(ref[k] - start[k]))) or 1.0)
            for k in moving if k in ref}


def fixed_run(ck, model, Y0, stepper, dt, n, spc, forcing=None, grid=None):
    """``n`` steps of ``dt`` through the kernel from ``Y0``, ``spc`` per
    launch (``n`` a multiple of it): the fixed-dt reference of phase 13c."""
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=spc,
                                   forcing_fields=tuple(forcing or ()), forcing_time_grid=grid)
    Y = _clone(Y0)
    dtype = model.float_dtype
    t = torch.as_tensor(0.0, dtype=dtype)
    for _ in range(n // spc):
        run(Y, t, forcing=forcing)
        t = t + spc * torch.as_tensor(dt, dtype=dtype)
    torch.cuda.synchronize()
    return _np(Y)


def adaptive_path(ck, smi, what, model, Y0, Ya, stepper, spc, tf, dt0, config, moving, forcing=None,
                  forcing_dt=None):
    """One adaptive run at full width (``run_adaptive_fused``, or with
    ``forcing`` ``run_adaptive_forced(engine="fused")``), with the launch
    counts set to 0 just before it and read just after; prints its counts,
    rates, kernel ms per launch (CUDA events recorded around each kernel
    call of the run, after its host tables), busy share (their sum over the
    wall time) and host time per iteration; holds the first iteration's first half-step launch (at
    ``dt_run`` = dt / 2: the other two launches of the iteration are the same instance, whose run-time
    dt 13b holds in every mode and whose chained launches 13a's replays hold) to the plain version on
    ``ADAPTIVE_SAMPLE`` evenly spaced columns (the plain launch's seconds printed).
    Returns ``(final state, log, run, launches, first-iteration max abs
    error)``."""
    from landhydrology_tpu_torch.adaptive import run_adaptive_forced, run_adaptive_fused

    dtype = model.float_dtype
    soil = getattr(model, "soil", model)
    nz, ncol = next(iter(Y0["soil"].values())).shape
    device = next(iter(Y0["soil"].values())).device
    grid = None
    if forcing is not None:
        grid = (0.0, float(forcing_dt), next(iter(forcing.values())).shape[0])
    run = ck.make_fused_column_run(model, stepper, dt=dt0, steps_per_call=spc, forcing_fields=tuple(forcing or ()),
                                   forcing_time_grid=grid)
    # CUDA events around each kernel call of the run, after its host tables: the device time
    log, starts, events = [], [], []
    launch_args, launch = ck.FusedColumnRun.launch_args, ck.FusedColumnRun._launch

    def args_then_start(self, *args, **kwargs):
        out = launch_args(self, *args, **kwargs)
        starts.append(torch.cuda.Event(enable_timing=True))
        starts[-1].record()
        return out

    def launch_then_end(self, *args, **kwargs):
        launch(self, *args, **kwargs)
        events.append((starts[-1], torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    ck.FusedColumnRun.launch_args, ck.FusedColumnRun._launch = args_then_start, launch_then_end
    try:
        t_wall = time.perf_counter()
        if forcing is None:
            Yf, stats = run_adaptive_fused(model, Y0, Ya, 0.0, tf, dt0, stepper=stepper, config=config,
                                           steps_per_call=spc, log=log)
        else:
            Yf, stats = run_adaptive_forced(model, Y0, Ya, 0.0, tf, dt0, forcing=forcing, forcing_dt=forcing_dt,
                                            stepper=stepper, config=config, engine="fused", steps_per_call=spc,
                                            log=log)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_wall) * 1e3
    finally:
        ck.FusedColumnRun.launch_args, ck.FusedColumnRun._launch = launch_args, launch
    launches = dict(ck.LAUNCHES)
    device_ms = sum(a.elapsed_time(b) for a, b in events)
    n_iter = len(log)
    if launches != {run.name: 3 * n_iter}:
        raise AssertionError(f"13 {what}: launches {launches}, expected {3 * n_iter} of {run.name}")
    final = _np(Yf)
    if not (bool(stats["converged"]) and all(np.isfinite(v).all() for v in final.values())):
        raise AssertionError(f"13 {what}: not converged ({stats}) or non-finite")
    k_ms = device_ms / len(events) if events else float("nan")
    # the first iteration's first half-step launch (at dt_run = dt / 2) against the plain version on
    # ADAPTIVE_SAMPLE columns
    t = log[0][0]
    half = run.step_size(0.5 * torch.tensor(log[0][1], dtype=dtype))
    stride = ncol // ADAPTIVE_SAMPLE
    idx = torch.arange(0, ncol, stride, device=device)
    sub, Ys = column_slice(soil, {"soil": Y0["soil"]}, idx)
    sub_model = sub if model is soil else dataclasses.replace(model, soil=sub)
    if "surface" in Y0:
        Ys["surface"] = {"h_s": Y0["surface"]["h_s"][idx].contiguous()}
    sub_stepper = dataclasses.replace(stepper, model=sub) if hasattr(stepper, "model") else stepper
    rows = None if forcing is None else {k: v[:, idx].contiguous() if v.dim() == 2 else v for k, v in forcing.items()}

    def plain(Y, t0, h):
        return ck.fused_column_run_plain(sub_model, sub_stepper, h, spc, Y, t0, forcing=rows, forcing_time_grid=grid)

    cols = idx.cpu().numpy()
    start = {k: v[..., cols] for k, v in _np(Y0).items()}
    kh = {k: v[..., cols] for k, v in _np(run(_clone(Y0), t, forcing=forcing, dt_run=half)).items()}
    clock = time.perf_counter()
    ph = plain(Ys, t, half)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - clock
    err = 0.0
    shares = {}
    # in f32 the first segment can move a field by less than the f32 bar
    # (bench.py's first 32 s), so only f64 requires the fields to move
    must_move = moving if dtype == torch.float64 else ()
    for kern, ref, label in ((kh, ph, "first half"),):
        ref = _np(ref)
        _check(kern, ref, dtype, f"13 {what} {label}")
        shares[label] = _check_increment(kern, ref, start, dtype, f"13 {what} {label}", must_move)
        err = max(err, _max_abs(kern, ref))
    n_acc, n_rej = int(stats["n_accepted"]), int(stats["n_rejected"])
    busy = device_ms / wall_ms
    print(f"[13 {what}] {str(dtype)[6:]} {run.name} nz={nz} x {ncol}, {spc} steps per segment, {tf!r} s from dt0 "
          f"{dt0!r}: {n_acc} accepted, {n_rej} rejected, dt_final {float(stats['dt_final'])!r}, launches {launches}; "
          f"wall {wall_ms:.3f} ms: {tf / (wall_ms / 1e3):.4e} simulated s per wall s, "
          f"{nz * ncol * spc * n_acc / (wall_ms / 1e3):.4e} accepted grid-point steps per s "
          f"({nz * ncol * spc * 3 * n_iter / (wall_ms / 1e3):.4e} launched); kernel {k_ms:.3f} ms per launch "
          f"(CUDA events around each), busy {busy:.3f}, host {(wall_ms - device_ms) / n_iter:.3f} ms per "
          f"iteration; "
          f"first iteration's first half-step launch vs plain on every {stride}th column ({plain_s:.1f} s of "
          f"plain launch): max abs "
          f"{err:.3e}, change error / largest "
          f"change " + "; ".join(f"{k} {_fmt(v)}" for k, v in shares.items()) + f" on {smi}", flush=True)
    return final, log, run, launches[run.name], err, k_ms


def adaptive_phase(ck, gc, costs, smi, device):
    """Phase 13c: the adaptive runs at full width, f32 and f64: bench.py's
    configuration under SSPRK33 (B1 at dt_run), the stiff path under
    TR-BDF2 and SSPRK33 (B4-trbdf2-water, B1-water), the reanalysis
    LandModel with the first ``ADAPTIVE_FORCED_ROWS`` rows of its forcing as
    a time-indexed table (B6+B7-time) and its soil alone under TR-BDF2
    (B4-trbdf2+B5+B7-time; the LandModel in f32 alone since phase 18),
    each against a finer fixed-dt kernel run (the stiff path: phase 8's
    SSPRK33 at dt_exp, RMSE below 1e-2).  Then
    the B4+B5 modes timed at the reanalysis width.  Returns the kernel
    records of the B4+B5 modes."""
    from landhydrology_tpu_torch.adaptive import AdaptiveConfig
    from landhydrology_tpu_torch.timestepping import SSPRK33

    entries = []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        config = AdaptiveConfig()
        # bench.py::build, an hour from dt0 = 1 s
        model, Y0, Ya = build_bench_model(NZ, NCOL, dtype, device)
        final, log, run, _, _, _ = adaptive_path(ck, smi, "adaptive bench", model, Y0, Ya, SSPRK33(), SPC, 3600.0,
                                                 1.0, config, ("vartheta_l", "rho_e_int"))
        fine_check(ck, "adaptive bench", model, Y0, SSPRK33(), SPC, 3600.0, log, final, config)
        del Y0, Ya, final
        torch.cuda.empty_cache()
        _mark(T_START, f"phase 13c's {tag} bench run")
        # the stiff path over phase 8's horizon, TR-BDF2 and SSPRK33, 8 steps per segment
        model, Y0, Ya = build_stiff(NZ, NCOL, dtype, device)
        dt_exp = stiff_dt_explicit(model, Y0)
        horizon = STIFF_STEPS * STIFF_FACTOR * dt_exp
        ref = fixed_run(ck, model, Y0, SSPRK33(), dt_exp, STIFF_STEPS * STIFF_FACTOR, STIFF_FACTOR)
        counts = {}
        for label, st in (("TR-BDF2", implicit("TRBDF2Soil", model, 2)), ("SSPRK33", SSPRK33())):
            final, log, run, _, _, _ = adaptive_path(ck, smi, f"adaptive stiff {label}", model, Y0, Ya, st,
                                                     STIFF_STEPS, horizon, dt_exp, config, ("vartheta_l",))
            rmse = float(np.sqrt(np.mean((final["vartheta_l"] - ref["vartheta_l"]) ** 2)))
            if not rmse < 1e-2:
                raise AssertionError(f"13 adaptive stiff {label} {tag}: RMSE {rmse} against SSPRK33 at dt_exp")
            counts[label] = (sum(r[3] for r in log), sum(not r[3] for r in log))
            print(f"[13 adaptive stiff] {tag} {run.name} ({label}) vs SSPRK33 at dt_exp {dt_exp!r} s over "
                  f"{horizon!r} s: RMSE {rmse:.4e} (bench.py bar 1e-2), max deviation "
                  f"{float(np.max(np.abs(final['vartheta_l'] - ref['vartheta_l']))):.4e}", flush=True)
        print(f"[13 adaptive stiff] {tag} segments of {STIFF_STEPS} steps (accepted, rejected): "
              + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
        del Y0, Ya, ref, final
        torch.cuda.empty_cache()
        _mark(T_START, f"phase 13c's {tag} stiff runs")
        # the reanalysis LandModel under its first rows as a time-indexed table (in f32 alone since phase 18:
        # a cut for the script's time; its f64 instance, B6+B7-time, meets the plain version in phase 11), and
        # its soil under TR-BDF2
        land, Y0, Ya = build_reanalysis(FORCED_NZ, FORCED_NCOL, dtype, device)
        _, fields = reanalysis_forcing(ADAPTIVE_FORCED_ROWS, FORCED_NCOL, FORCED_DT)
        rows = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in fields.items()}
        del fields
        tf = ADAPTIVE_FORCED_ROWS * FORCED_DT
        forced_config = AdaptiveConfig(dt_max=FORCED_DT)
        soil_rows = {k: v for k, v in rows.items() if k != "precipitation"}
        for label, model, Ys, st, r, moving in (
                ("LandModel", land, Y0, SSPRK33(), rows, ("vartheta_l", "rho_e_int", "h_s")),
                ("soil TR-BDF2", land.soil, {"soil": Y0["soil"]}, implicit("TRBDF2Soil", land.soil, 2), soil_rows,
                 ("vartheta_l", "rho_e_int"))):
            if label == "LandModel" and dtype == torch.float64:
                continue
            final, log, run, launches, err, k_ms = adaptive_path(
                ck, smi, f"adaptive forced {label}", model, Ys, Ya, st, FORCED_SPC, tf, FORCED_DT / 4, forced_config,
                moving, forcing=r, forcing_dt=FORCED_DT)
            fine_check(ck, f"adaptive forced {label}", model, Ys, st, FORCED_SPC, tf, log, final, forced_config,
                       forcing=r, grid=(0.0, FORCED_DT, ADAPTIVE_FORCED_ROWS))
            if run.mode & ck.MODE_IMPLICIT:
                entries.append(time_b4_b5(ck, costs, smi, dtype, device, "TRBDF2Soil", True, launches, err))
            _mark(T_START, f"phase 13c's {tag} forced {label}")
        del land, Y0, Ya, rows, soil_rows
        torch.cuda.empty_cache()
        for name in ("TRBDF2Soil", "BackwardEulerSoil", "BackwardEulerRichards"):
            entries.append(time_b4_b5(ck, costs, smi, dtype, device, name, False, None, None))
        torch.cuda.empty_cache()
    return entries


def fine_check(ck, what, model, Y0, stepper, spc, tf, log, final, config, forcing=None, grid=None):
    """Hold an adaptive run's final state to a fixed-dt kernel run over the
    same horizon at the largest accepted dt over ``FINE_DIVISOR`` (rounded
    to a whole number of launches of ``spc`` steps): every field within the
    tolerance the controller accepted, summed over the accepted segments
    (``n_accepted * (atol + rtol * max |field|)``).  Prints the deviation
    of each field, that bar, and the deviation over the field's largest
    change."""
    dt_big = max(r[1] for r in log if r[3])
    n = spc * math.ceil(tf * FINE_DIVISOR / (dt_big * spc))
    ref = fixed_run(ck, model, Y0, stepper, tf / n, n, spc, forcing, grid)
    n_acc = sum(1 for r in log if r[3])
    held = {}
    for k, v in ref.items():
        dev = float(np.max(np.abs(final[k] - v)))
        bar = n_acc * (config.atol + config.rtol * float(np.max(np.abs(v))))
        if not dev <= bar:
            raise AssertionError(f"13 {what}/{k}: {dev!r} from {n} fixed steps of {tf / n!r} s, past {bar!r}")
        held[k] = (dev, bar)
    shares = _moving_share(final, ref, _np(Y0), list(ref))
    print(f"[13 {what}] {str(model.float_dtype)[6:]} against {n} fixed steps of {tf / n!r} s (the largest accepted "
          f"dt {dt_big!r} s / {FINE_DIVISOR}): max abs deviation (bar: {n_acc} accepted segments x (atol + rtol "
          f"max |field|)) " + ", ".join(f"{k} {d:.3e} ({b:.3e})" for k, (d, b) in held.items())
          + f"; deviation / largest change {_fmt(shares)}", flush=True)


def time_b4_b5(ck, costs, smi, dtype, device, name, forced, launches, err):
    """The timing of a B4+B5 mode (implicit stepper ``name`` with two
    iterations; with ``forced``, under the reanalysis rows as a
    time-indexed table) on the reanalysis soil at ``B4_B5_TIMED_NCOL``
    columns: the kernel per launch (``time_forced``, CUDA events) of
    ``B4_B5_TIMED_STEPS`` steps of dt=120, beside its bound (the MOST
    solves' probes counted from the plain version's); the plain version
    timed over one step on every ``COLD_PROBE_STRIDE``-th column, which
    also counts the probes (``plain_at``; phase 19's cut of plain launches:
    was the whole launch).  ``launches`` and ``err`` come from the run that
    drove the mode, or (as ``None``) from phase 13b's launch."""
    spc, ncol = B4_B5_TIMED_STEPS, B4_B5_TIMED_NCOL
    land, Y0, _ = build_reanalysis(FORCED_NZ, ncol, dtype, device)
    model, Y0 = land.soil, {"soil": Y0["soil"]}
    stepper = implicit(name, model, 2)
    nz = FORCED_NZ
    rows = grid = None
    if forced:
        _, fields = reanalysis_forcing(ADAPTIVE_FORCED_ROWS, ncol, FORCED_DT)
        rows = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in fields.items() if k != "precipitation"}
        grid = (0.0, FORCED_DT, ADAPTIVE_FORCED_ROWS)
    timed = ck.make_fused_column_run(model, stepper, dt=FORCED_DT, steps_per_call=spc,
                                     forcing_fields=tuple(rows or ()), forcing_time_grid=grid)
    few = torch.arange(0, ncol, COLD_PROBE_STRIDE, device=device)
    sub, Ys = column_slice(model, Y0, few)
    sub_rows = None if rows is None else {k: v[:, few].contiguous() for k, v in rows.items()}
    _, _, probes, plain_1 = _counting_solves(lambda: ck.fused_column_run_plain(
        sub, implicit(name, sub, 2), FORCED_DT, 1, Ys, 0.0, forcing=sub_rows, forcing_time_grid=grid))
    k_ms, p_ms, probes = time_forced(ck, timed, model, Y0, rows, FORCED_DT, spc, grid, stepper=stepper,
                                     checked=(plain_1, probes))
    read = len(rows) * next(iter(rows.values())).numel() if rows else 0
    b_ms, b_by = bound_ms(ck, costs, timed.mode, dtype, nz * ncol, spc, iters=stepper.iters, ncol=ncol,
                          probes=probes, read_values=read)
    print(f"[13 time] {str(dtype)[6:]} {timed.name} {spc} steps of dt={FORCED_DT:g} nz={nz} x {ncol}: kernel "
          f"{k_ms:.3f} ms ({nz * ncol * spc / (k_ms / 1e3):.4e} grid-points/s), plain {p_ms:.3f} ms (one step on "
          f"{len(few)} columns), bound "
          f"{b_ms:.3f} ms by {b_by} ({b_ms / k_ms:.3f} of the kernel's time), MOST probes per solve {probes:.4f}, "
          f"{most_exchanges(ck, timed.mode, stepper.iters)} solves per step on {smi}", flush=True)
    return (dtype, timed.name, launches, err, k_ms, p_ms, b_ms, b_by, timed)


def adaptive_entries(ck, timed, dt_run_records):
    """The kernel records of phase 13's B4+B5 modes: launches and error from
    the run that drove each (13c), or from its launch in 13b."""
    entries = []
    for dtype, name, launches, err, k_ms, p_ms, b_ms, b_by, run in timed:
        if launches is None:
            launches, err = dt_run_records[(dtype, name)]
        entry = forced_entry(ck, run, dtype, launches, err, k_ms, p_ms, b_ms, b_by)
        entry["plain_at"] = f"13: nz={FORCED_NZ} x {len(range(0, B4_B5_TIMED_NCOL, COLD_PROBE_STRIDE))}, 1 step"
        entries.append(entry)
    return entries


def adaptive_main(ck, gc, costs, smi, device, t_start):
    """Phase 13: 13a (``adaptive_small``), 13b (``dt_run_phase``), 13c
    (``adaptive_phase``).  Returns the kernel records of the B4+B5 modes."""
    adaptive_small(ck, gc, device)
    _mark(t_start, "phase 13a")
    dt_run_records = dt_run_phase(ck, device)
    _mark(t_start, "phase 13b")
    timed = adaptive_phase(ck, gc, costs, smi, device)
    return adaptive_entries(ck, timed, dt_run_records)


# ---- phase 14: the gradient path (ROADMAP A17), kernel modes B9 and B4 + step policies ----

#: 14b: every plain-soil mode as a B9 forward on this many columns, steps per launch
GRAD_NCOL, GRAD_STEPS = 1000, 2
#: 14b: the B4 + policy instances timed at nz=64 x this many columns, steps per launch
POLICY_NCOL, POLICY_STEPS, POLICY_DT = 16384, 4, 60.0
#: the step policies the implicit kernel takes on the coupled soil, as model options
B4_POLICIES = (
    {"coefficient_update": "step"}, {"freeze_thaw": "rate"}, {"freeze_thaw": "eq"}, {"assume_no_ice": True},
    {"coefficient_update": "step", "freeze_thaw": "rate"}, {"coefficient_update": "step", "freeze_thaw": "eq"},
)
#: 14c: the full-width gradient runs: (configuration, stepper, steps per launch, dt), at half their depth since
#: phase 20's cut (were 32 and 8 steps), TR-BDF2's halved again for phase 21 (was 4: its backward took 3.4-4.0 s)
GRAD_WIDE = (("bench", "SSPRK33", SPC // 2, DT), ("freeze", "TRBDF2Soil", 2, 60.0))


def _policy(model, options):
    """``model`` with the step policies ``options`` (freeze-thaw named
    ``"rate"``, tau = 60 s, or ``"eq"``)."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw

    options = dict(options)
    if "freeze_thaw" in options:
        options["freeze_thaw"] = FreezeThaw(tau=60.0) if options["freeze_thaw"] == "rate" else EquilibriumFreezeThaw()
    return dataclasses.replace(model, **options)


def _weights(gc, Y):
    """The loss weights of the gradient sweep (``sweep_weights``) of the
    soil state ``Y``, on its device in its dtype."""
    W = gc.sweep_weights({"soil": {k: v.detach().cpu().numpy() for k, v in Y["soil"].items()}})["soil"]
    return {k: torch.as_tensor(w).to(Y["soil"][k].device, Y["soil"][k].dtype) for k, w in W.items()}


def _weighted(W, out):
    return sum(torch.sum(W[k] * out[k]) for k in out)


def grad_small(ck, gc, device):
    """14a: ``golden_grad_f64.npz`` through B9 on the card (the kernel's
    forward, one launch each), loss at rtol 1e-12, gradients within 1e-10
    of their scale; on the MOST soils (``MOST_CASES``), AD along the
    golden's directions and in dt within rtol 1e-7 of the JAX package's
    forward differenced; on the JAX fused test's column, the gradient in
    vartheta_l against central differences along three random directions
    (rtol 5e-5) and d/d dt not zero and within rtol 1e-5 of its central
    difference."""
    golden = np.load(os.path.join(HERE, "tests", "data", "golden_grad_f64.npz"))
    f64 = torch.float64
    for name, case in gc.GRAD_CASES.items():
        model, Y, stepper, _ = gc.build_grad_case(name, f64, device)
        run = ck.make_fused_column_run(model, stepper, dt=case["dt"], steps_per_call=case["steps"],
                                       differentiable=True)
        start = {k: v.clone().requires_grad_(True) for k, v in Y["soil"].items()}
        t0 = torch.tensor(case["t0"], dtype=f64, requires_grad=True)
        dt = torch.tensor(case["dt"], dtype=f64, requires_grad=True)
        ck.LAUNCHES.clear()
        out = run({"soil": start}, t0, dt_run=dt)["soil"]
        torch.cuda.synchronize()
        if dict(ck.LAUNCHES) != {run.name: 1}:
            raise AssertionError(f"golden grad {name}: launches {dict(ck.LAUNCHES)}, expected one of {run.name}")
        loss = gc.grad_loss(out, {k: v.detach() for k, v in start.items()})
        grads = torch.autograd.grad(loss, list(start.values()) + [t0, dt], allow_unused=True)
        np.testing.assert_allclose(float(loss), float(golden[f"{name}__loss"]), rtol=1e-12, err_msg=name)
        devs = {}
        for k, d in zip(start, grads):
            ref = golden[f"{name}__g_{k}"]
            scale = float(np.max(np.abs(ref))) or 1.0
            devs[k] = float(np.max(np.abs(d.cpu().numpy() - ref))) / scale
            if not devs[k] <= 1e-10:
                raise AssertionError(f"golden grad {name} d/d{k}: {devs[k]:.3e} of its scale > 1e-10")
        for what, d in (("t0", grads[-2]), ("dt", grads[-1])):
            got, ref = 0.0 if d is None else float(d), float(golden[f"{name}__g_{what}"])
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-300, err_msg=f"{name} d/d{what}")
        print(f"[14a grad golden] f64 {run.name} {name} {tuple(next(iter(start.values())).shape)} "
              f"{case['steps']} steps: loss {float(loss)!r} (golden rel {abs(float(loss) / float(golden[f'{name}__loss']) - 1):.3e}, "
              f"bar 1e-12); gradient deviation / scale {_fmt(devs)} (bar 1e-10); d/dt0 "
              f"{0.0 if grads[-2] is None else float(grads[-2])!r}, d/ddt {float(grads[-1])!r}", flush=True)
    # the MOST soils: AD against the JAX package's forward differenced (most__)
    for name, case in gc.MOST_CASES.items():
        if case["model"] != "soil":
            continue
        model, Y, _, stepper, _ = gc.build_most_case(name, f64, device)
        run = ck.make_fused_column_run(model, stepper, dt=case["dt"], steps_per_call=case["steps"],
                                       differentiable=True)
        W = _weights(gc, Y)
        start = {k: v.clone().requires_grad_(True) for k, v in Y["soil"].items()}
        dt = torch.tensor(case["dt"], dtype=f64, requires_grad=True)
        ck.LAUNCHES.clear()
        out = run({"soil": start}, 0.0, dt_run=dt)["soil"]
        torch.cuda.synchronize()
        if dict(ck.LAUNCHES) != {run.name: 1}:
            raise AssertionError(f"MOST grad {name}: launches {dict(ck.LAUNCHES)}, expected one of {run.name}")
        loss = _weighted(W, out)
        grads = torch.autograd.grad(loss, list(start.values()) + [dt])
        ad = [sum(float(torch.sum(d.cpu() * torch.as_tensor(dr["soil"][k]))) for k, d in zip(start, grads))
              for dr in gc.most_fd_directions(golden, name)]
        fd, fd_dt = golden[f"most__{name}__fd"], float(golden[f"most__{name}__fd_dt"])
        np.testing.assert_allclose(float(loss), float(golden[f"most__{name}__loss"]), rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(ad, fd, rtol=1e-7, err_msg=f"MOST grad {name} directions")
        np.testing.assert_allclose(float(grads[-1]), fd_dt, rtol=1e-7, err_msg=f"MOST grad {name} d/d dt")
        print(f"[14a grad golden] f64 {run.name} {name} {tuple(start['vartheta_l'].shape)} {case['steps']} steps: "
              f"AD vs the JAX package's forward differenced along three directions rel "
              f"{float(np.max(np.abs(np.array(ad) - fd) / np.abs(fd))):.3e}, in dt rel "
              f"{abs(float(grads[-1]) / fd_dt - 1):.3e} (bar 1e-7)", flush=True)
    # test_differentiability.py's column: FD along three directions, and d/d dt
    model, Y = gc.build_grad_column(f64, device)
    run = ck.make_fused_column_run(model, dt=20.0, steps_per_call=6, differentiable=True)

    def loss_of(v0, dt=20.0):
        return torch.mean((run({"soil": dict(Y["soil"], vartheta_l=v0)}, 0.0, dt_run=dt)["soil"]["vartheta_l"]
                           - 0.25) ** 2)

    v0 = Y["soil"]["vartheta_l"].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_of(v0), v0)
    gen = torch.Generator().manual_seed(0)
    rel = []
    with torch.no_grad():
        for _ in range(3):
            d = torch.randn(tuple(v0.shape), generator=gen, dtype=f64).to(device)
            d = d / torch.linalg.norm(d)
            fd = (float(loss_of(v0 + 1e-6 * d)) - float(loss_of(v0 - 1e-6 * d))) / 2e-6
            ad = float(torch.sum(g * d))
            np.testing.assert_allclose(ad, fd, rtol=5e-5, atol=1e-12, err_msg="column FD")
            rel.append(abs(ad - fd) / abs(fd))
    dt = torch.tensor(20.0, dtype=f64, requires_grad=True)
    (g_dt,) = torch.autograd.grad(loss_of(Y["soil"]["vartheta_l"], dt), dt)
    with torch.no_grad():
        fd_dt = (float(loss_of(Y["soil"]["vartheta_l"], 20.0 + 1e-3))
                 - float(loss_of(Y["soil"]["vartheta_l"], 20.0 - 1e-3))) / 2e-3
    if not float(g_dt) != 0.0:
        raise AssertionError("d loss / d dt is zero")
    np.testing.assert_allclose(float(g_dt), fd_dt, rtol=1e-5, err_msg="d/d dt")
    print(f"[14a grad golden] f64 {run.name} test_differentiability column: AD vs central differences on three "
          f"directions rel {', '.join(f'{r:.3e}' for r in rel)} (bar 5e-5); d/d dt {float(g_dt)!r} vs FD "
          f"{fd_dt!r} (bar 1e-5)", flush=True)


def b9_modes(gc, dtype, device):
    """``(model, Y, stepper, dt)`` of every plain-soil mode of the kernel
    table on ``GRAD_NCOL`` columns: the coupled SSPRK33 modes and the
    implicit steppers on ``build_variant_model``'s column (Thomas, and PCR
    under TR-BDF2), each with the step policies it takes; the water-only and
    heat-only branches under SSPRK33 and TR-BDF2, backward Euler for
    Richards on the stiff water-only column; per-column kinds and depths
    (``build_grid_variant``) under SSPRK33 and TR-BDF2; a MOST top
    (``build_land_variant``'s soil) under SSPRK33, with lagged coefficients,
    and under TR-BDF2."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    out = []
    for options in ({}, {"assume_no_ice": True}, *B4_POLICIES[:3], *B4_POLICIES[4:],
                    {"coefficient_update": "step", "assume_no_ice": True}):
        model, Y = build_variant_model(GRAD_NCOL, dtype, device, seed=7)
        out.append((_policy(model, options), Y, SSPRK33(), 5.0))
    for name in ("TRBDF2Soil", "BackwardEulerSoil", "BackwardEulerRichards"):
        for options in ({}, *B4_POLICIES):
            model, Y = build_variant_model(GRAD_NCOL, dtype, device, seed=7)
            model = _policy(model, options)
            out.append((model, Y, implicit(name, model, 2), 60.0))
        if name == "TRBDF2Soil":
            for options in ({}, B4_POLICIES[5]):
                model, Y = build_variant_model(GRAD_NCOL, dtype, device, seed=7)
                model = _policy(model, options)
                out.append((model, Y, implicit(name, model, 2, "pcr"), 60.0))
    for model, Y0, stepper, dt, _, _, _ in branch_variants(dtype, device, GRAD_NCOL):
        out.append((model, Y0, stepper, dt))
    model, Y, _ = build_stiff(16, GRAD_NCOL, dtype, device)
    out.append((model, Y, implicit("BackwardEulerRichards", model, 2), 5.0))
    for case in ("B1", "B4-trbdf2"):
        model, Y, stepper, dt, _ = build_grid_variant(GRAD_NCOL, dtype, device, 11, case)
        out.append((model, Y, stepper, dt))
    for case, name, dt in (("B5", None, 2.0), ("B2+B5", None, 2.0), ("B5", "TRBDF2Soil", 60.0)):
        model, Y = build_land_variant(GRAD_NCOL, dtype, device, 13, case)
        out.append((model, Y, SSPRK33() if name is None else implicit(name, model, 2), dt))
    return out


def b9_forward(ck, gc, model, Y, stepper, dt, n):
    """One B9 launch of ``n`` steps from t0 = 2 s: the launch count, the
    forward equal bit for bit to the non-differentiable run's, and the
    gradient of a weighted sum of the state in the start state, t0 and dt,
    finite and within the repo's bars (f64 1e-12 of each gradient's scale,
    f32 1e-4) of autograd through the whole launch's plain version.
    Returns ``(name, largest gradient deviation / scale)``."""
    dtype = model.float_dtype
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n, differentiable=True)
    start = {k: v.clone().requires_grad_(True) for k, v in Y["soil"].items()}
    t0 = torch.tensor(2.0, dtype=dtype, requires_grad=True)
    dt_t = torch.tensor(dt, dtype=dtype, requires_grad=True)
    W = _weights(gc, Y)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    out = run({"soil": start}, t0, dt_run=dt_t)["soil"]
    torch.cuda.synchronize()
    if dict(ck.LAUNCHES) != {run.name: 1}:
        raise AssertionError(f"{run.name}: launches {dict(ck.LAUNCHES)}")
    plain_run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=n)
    ref = _clone(Y)
    with torch.no_grad():
        plain_run(ref, 2.0)
    for k, v in out.items():
        if not torch.equal(v.detach(), ref["soil"][k]):
            raise AssertionError(f"{run.name}: the B9 forward differs from the non-differentiable run in {k}")
    inputs = list(start.values()) + [t0, dt_t]
    got = torch.autograd.grad(_weighted(W, out), inputs, allow_unused=True)
    whole = ck.fused_column_run_plain(model, stepper, dt_t, n, {"soil": start}, t0)["soil"]
    want = torch.autograd.grad(_weighted(W, whole), inputs, allow_unused=True)
    bar = 1e-12 if dtype == torch.float64 else 1e-4
    worst = 0.0
    for what, a, b in zip(list(start) + ["t0", "dt"], got, want):
        a = torch.zeros(()) if a is None else a.detach().double().cpu()
        b = torch.zeros(()) if b is None else b.detach().double().cpu()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{run.name}: d/d{what} not finite")
        scale = float(b.abs().max()) or 1.0
        dev = float((a - b).abs().max()) / scale
        if not dev <= bar:
            raise AssertionError(f"{run.name}: d/d{what} deviates by {dev:.3e} of its scale (bar {bar:g})")
        worst = max(worst, dev)
    return run.name, worst


def time_policy(ck, costs, smi, model, Y0, stepper, what):
    """A 14b policy path (``POLICY_STEPS`` steps of ``POLICY_DT`` from
    ``Y0``), checked and timed in turns as phase 6 times its paths: the plain
    version (timed once; its state is the check's reference), the kernel's
    launch against it (``check_variant`` with the freeze bars: rho_e_int
    crosses zero where the column cools through T_0), the kernel x5 twice.
    Returns ``(kernel record, error, shares)``."""
    plain = []
    plain_fn = lambda: plain.append(ck.fused_column_run_plain(  # noqa: E731
        model, stepper, POLICY_DT, POLICY_STEPS, Y0, 0.0))
    p1 = _time_ms(plain_fn, 1)
    Yk = _clone(Y0)
    kern, ref, shares = check_variant(
        ck, model, Yk, POLICY_DT, POLICY_STEPS, 0.0, what, ("vartheta_l", "rho_e_int"), stepper=stepper,
        check=lambda a, b, dt_, w: _check_freeze(a, b, model, dt_, w), plain=plain.pop())
    err = _max_abs(kern, ref)
    del kern, ref
    run = ck.make_fused_column_run(model, stepper, dt=POLICY_DT, steps_per_call=POLICY_STEPS)
    k1 = _time_ms(lambda: run(Yk, 0.0), 5)
    k2 = _time_ms(lambda: run(Yk, 0.0), 5)
    entry = time_record(ck, costs, smi, model, Y0, POLICY_DT, POLICY_STEPS, stepper, 1, err, (k1, k2), (p1,),
                        None)
    return entry, err, shares


#: 14b's B9 modes, f64 and f32 (a cut for the script's time from every mode of ``b9_modes``): the
#: coupled SSPRK33 mode and the lagged freeze-thaw ones (their f32 instances have no other check against
#: the plain version), the implicit steppers, a branch each, the MOST top (14a holds B9 on the MOST
#: soils to the JAX package's differences in f64)
B9_MODES = frozenset({"B1", "B2+B3-rate", "B2+B3-eq", "B4-trbdf2+B3-rate", "B4-be-soil", "B4-be-richards",
                          "B1-water", "B4-trbdf2-heat", "B5", "B4-trbdf2+B5"})


def grad_modes(ck, gc, costs, smi, device, t_start):
    """14b: ``b9_forward`` of the plain-soil modes (``b9_modes``) in
    ``B9_MODES``, f64 and f32 (a cut for the script's time: the other modes'
    instances are held to their plain version in phases 3-5, 8-10, 12, 13
    and 14b's policy paths, and the B9 forward is the mode's launch); then each B4 + policy instance, and each implicit stepper without
    a policy for comparison, checked against its plain version and timed
    (``time_policy``) at nz=64 x ``POLICY_NCOL`` (``build_freeze_wide``'s
    column, ``POLICY_STEPS`` steps of ``POLICY_DT``).  Returns the kernel
    records of the policy paths."""
    entries = []
    for dtype in (torch.float64, torch.float32):
        cases = [(model, Y, stepper, dt) for model, Y, stepper, dt in b9_modes(gc, dtype, device)
                 if ck.make_fused_column_run(model, stepper).name in B9_MODES]
        results = [b9_forward(ck, gc, model, Y, stepper, dt, GRAD_STEPS) for model, Y, stepper, dt in cases]
        print(f"[14b B9 modes] {str(dtype)[6:]} {len(results)} modes on {GRAD_NCOL} columns, {GRAD_STEPS} steps: "
              "B9 forward = the kernel's run bit for bit; gradient deviation / scale from the whole launch's "
              "plain version: " + ", ".join(f"{n} {d:.1e}" for n, d in results), flush=True)
        _mark(t_start, f"phase 14b's {str(dtype)[6:]} B9 modes")
        base, Y0, _, _ = build_freeze_wide(gc, dtype, device, None, ncol=POLICY_NCOL)
        base = dataclasses.replace(base, freeze_thaw=None)
        for name in ("TRBDF2Soil", "BackwardEulerSoil", "BackwardEulerRichards"):
            for options in ({}, *B4_POLICIES):
                for tridiag in ("thomas", "pcr") if name == "TRBDF2Soil" and options == B4_POLICIES[1] else ("thomas",):
                    wide = _policy(base, options)
                    st = implicit(name, wide, 2, tridiag)
                    entry, err, shares = time_policy(ck, costs, smi, wide, Y0, st, f"14b {name} {options}")
                    print(f"[14b policy] {str(dtype)[6:]} {ck.make_fused_column_run(wide, st).name} nz={NZ} "
                          f"ncol={POLICY_NCOL} {POLICY_STEPS} steps of {POLICY_DT}: kernel vs plain max abs "
                          f"{err:.3e}; change error / largest change {_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g})",
                          flush=True)
                    entries.append(entry)
        del base, Y0
        torch.cuda.empty_cache()
    return entries


def grad_wide(ck, gc, costs, smi, device):
    """14c: the gradient path at full width (``GRAD_WIDE``), f32 and f64:
    one B9 launch (its launch count set to 0 just before and read just
    after) against the plain version, the vjp of a weighted sum of the state
    in the start state, t0 and dt, with the forward's and the backward's ms
    (CUDA events), the backward's peak memory
    (``torch.cuda.max_memory_allocated`` after a reset), each field's
    gradient norm and, in f64, one directional central difference (rtol
    1e-4).  Returns the B9 kernel records."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import FreezeThaw
    from landhydrology_tpu_torch.timestepping import SSPRK33

    entries = []
    for config, stepper_name, spc, dt in GRAD_WIDE:
        for dtype in (torch.float32, torch.float64):
            if config == "bench":
                model, Y0, _ = build_bench_model(NZ, NCOL, dtype, device)
                stepper = SSPRK33()
            else:
                model, Y0, _, _ = build_freeze_wide(gc, dtype, device, FreezeThaw(tau=60.0))
                stepper = implicit(stepper_name, model, 2)
            run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=spc, differentiable=True)
            W = _weights(gc, Y0)
            start = {k: v.clone().requires_grad_(True) for k, v in Y0["soil"].items()}
            t0 = torch.tensor(0.0, dtype=dtype, requires_grad=True)
            dt_t = torch.tensor(dt, dtype=dtype, requires_grad=True)
            torch.cuda.synchronize()
            ck.LAUNCHES.clear()
            out = run({"soil": start}, t0, dt_run=dt_t)["soil"]
            torch.cuda.synchronize()
            launches = dict(ck.LAUNCHES)
            if launches != {run.name: 1}:
                raise AssertionError(f"14c {run.name}: launches {launches}")
            with torch.no_grad():
                fwd = [_time_ms(lambda: run({"soil": start}, t0, dt_run=dt_t), 3) for _ in range(2)]
                plain = []  # the checked launch timed (one sample)
                plain_ms = _time_ms(lambda: plain.append(ck.fused_column_run_plain(model, stepper, dt, spc, Y0, 0.0)),
                                    1)
                plain = _np(plain.pop())
            kern = _np({"soil": out})
            if model.freeze_thaw is None:
                _check(kern, plain, dtype, run.name)
            else:
                _check_freeze(kern, plain, model, dtype, run.name)
            err = _max_abs(kern, plain)
            loss = _weighted(W, out)
            del kern, plain
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            grads = torch.autograd.grad(loss, list(start.values()) + [t0, dt_t], allow_unused=True)
            e1.record()
            torch.cuda.synchronize()
            bwd_ms = e0.elapsed_time(e1)
            peak = torch.cuda.max_memory_allocated()
            norms = {k: float(torch.linalg.norm(d.double())) for k, d in zip(start, grads)}
            if not all(np.isfinite(v) for v in norms.values()):
                raise AssertionError(f"14c {run.name}: gradient not finite: {norms}")
            fd_line = ""
            if dtype == torch.float64:
                gen = torch.Generator().manual_seed(1)
                d = {k: (torch.randn(tuple(v.shape), generator=gen, dtype=torch.float64) * float(v.abs().max())
                         * (k != "theta_i")).to(device) for k, v in Y0["soil"].items()}
                ad = sum(float(torch.sum(g * d[k])) for k, g in zip(start, grads))
                # small: the freeze-thaw sources have kinks (at T_0, where freezing meets its
                # cap), and a difference across one is no derivative
                eps = 1e-8
                with torch.no_grad():
                    lp = float(_weighted(W, run({"soil": {k: v + eps * d[k] for k, v in Y0["soil"].items()}}, 0.0)["soil"]))
                    lm = float(_weighted(W, run({"soil": {k: v - eps * d[k] for k, v in Y0["soil"].items()}}, 0.0)["soil"]))
                fd = (lp - lm) / (2 * eps)
                np.testing.assert_allclose(ad, fd, rtol=1e-4, err_msg=f"14c {run.name} directional FD")
                fd_line = f"; directional AD {ad!r} vs central difference {fd!r} (rel {abs(ad - fd) / abs(fd):.3e}, bar 1e-4)"
            mode = run.inner.mode
            b_ms, b_by = bound_ms(ck, costs, mode, dtype, NZ * NCOL, spc, iters=2)
            ms = sum(fwd) / 2
            print(f"[14c grad wide] {str(dtype)[6:]} {run.name} {config} nz={NZ} ncol={NCOL} {spc} steps of {dt}: "
                  f"{launches[run.name]} launch, forward {fwd[0]:.3f}/{fwd[1]:.3f} ms (plain {plain_ms:.3f} ms, bound "
                  f"{b_ms:.3f} ms by {b_by}), kernel vs plain max abs {err:.3e}; backward {bwd_ms:.3f} ms, peak memory "
                  f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB over the {base / 2**30:.3f} GiB before it); "
                  f"gradient norms {_fmt(norms)}, d/dt0 {0.0 if grads[-2] is None else float(grads[-2])!r}, "
                  f"d/ddt {float(grads[-1])!r}{fd_line} on {smi}", flush=True)
            kernel, source = kernel_of(ck, mode, dtype)
            entries.append({
                "name": f"{kernel}<{str(dtype)[6:].replace('float', 'f')}, {run.name}>",
                "route": "cuda", "source": source, "replaces": REPLACES,
                "launches": launches[run.name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })
            del out, grads, loss, start
            torch.cuda.empty_cache()
    return entries


def grad_main(ck, gc, costs, smi, device, t_start):
    """Phase 14: 14a (``grad_small``), 14b (``grad_modes``), 14c
    (``grad_wide``).  Returns the kernel records of the B4 + policy paths
    and of the B9 runs."""
    grad_small(ck, gc, device)
    _mark(t_start, "phase 14a")
    entries = grad_modes(ck, gc, costs, smi, device, t_start)
    _mark(t_start, "phase 14b")
    return entries + grad_wide(ck, gc, costs, smi, device)


# ---- phase 16: the cold land path, kernel modes B5/B6 with freeze-thaw or no ice ----

#: the tops and the step policies of ``csrc/land_policy_kernel.cu``; its 30
#: modes per float type, each policy alone and with lagged coefficients
COLD_TOPS = ("B5", "B6", "B6-step", "B6-pond", "B6-step-pond")
COLD_POLICIES = ("+B3-rate", "+B3-eq", "-no-ice")
COLD_MODES = tuple(lag + top + policy for top in COLD_TOPS for policy in COLD_POLICIES for lag in ("", "B2+"))
#: 16a: each instance checked on this many columns over this many steps of 2 s; in f64 over COLD_STEPS_F64 since
#: phase 18 (a cut for the script's time: f64's change bar needs no more, f32's needs the water to move)
COLD_NCOL, COLD_STEPS, COLD_STEPS_F64 = 1000, 4, 2
#: 16b: the path's modes at nz=64 x 65,536, one launch of COLD_WIDE_STEPS steps of the freeze column's dt, each
#: held to the plain version by a launch of COLD_TIMED_STEPS steps (the cuts of plain launches of phases 19 and 20;
#: 16a holds their instance where ice acts)
COLD_PATHS = ("B6+B3-rate", "B2+B6-step+B3-rate", "B6+B3-eq")
COLD_WIDE_STEPS = 32
#: 16b: the atmosphere over the cold column
COLD_THETA_ATM = 263.15
#: 16c: each instance timed at nz=64 x 65,536 over launches of this many steps; a MOST
#: instance's bound counts the probes of its plain launch on every COLD_PROBE_STRIDE-th column
COLD_TIMED_STEPS, COLD_PROBE_STRIDE = 4, 256


def build_cold_land(gc, dtype, device, case, ncol=None, base=None):
    """16b and 16c: ``bench.py::build_land``'s LandModel (its MOST
    atmosphere with theta_atm at ``COLD_THETA_ATM``, the rain pulse of 8e-6
    m/s, tau_pond 300 s, a pond of 1e-4 m, a zero-flux bottom) around
    ``build_freeze_wide``'s cold column (nz=64 x 65,536 or ``ncol``,
    273.4-275.4 K, water 0.22-0.34, no ice), in mode ``case``: its soil
    alone for ``B5``, the column's own top (-10 C Dirichlet, zero water
    flux) under the pond for ``-pond``, the policy of ``cold_policy``;
    ``base``: that column as ``build_freeze_wide`` returned it, built once
    for several cases.  Returns ``(model, start state, Ya, dt)``."""
    from landhydrology_tpu_torch import PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC, VerticalFlux
    from landhydrology_tpu_torch.models.land import LandModel, PulsePrecipitation, SurfaceWaterModel

    top, policy = cold_policy(case)
    soil, Y, Ya, dt = build_freeze_wide(gc, dtype, device, None, ncol) if base is None else base
    ncol = Y["soil"]["vartheta_l"].shape[1]
    most = PrescribedAtmosForcing(u_atm=2.0, theta_atm=COLD_THETA_ATM, z_atm=2.0, theta_scale=297.0, rho_a_sfc=1.2,
                                  q_atm=0.005)
    soil = dataclasses.replace(soil, **{"freeze_thaw": None, **policy},
                               coefficient_update="step" if top.startswith("B2+") else "stage",
                               boundary_conditions=SoilColumnBC(
                                   top=soil.boundary_conditions.top if top.endswith("-pond") else most,
                                   bottom=SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0))))
    if top.endswith("B5"):
        return soil, Y, Ya, dt
    land = LandModel(soil=soil, surface=SurfaceWaterModel(
        precipitation=PulsePrecipitation(rate=8e-6, t_start=0.0, t_stop=1e9), tau_pond=300.0),
        surface_update="step" if "-step" in top else "stage")
    return land, dict(Y, surface={"h_s": torch.full((ncol,), 1e-4, dtype=dtype, device=device)}), Ya, dt


def _ice_columns(kern, start):
    """``(columns where theta_i grew, columns where it shrank)`` by more than
    a hundredth of a percent of the pore space."""
    change = kern["theta_i"] - start["theta_i"]
    return int((change > 1e-4 * 0.01).any(0).sum()), int((change < -1e-4 * 0.01).any(0).sum())


def cold_check(ck, name, dtype, device, icy=False, rows=False, time_grid=None, tag="16a", stepper=None, steps=None,
               columns=False):
    """16a, 17a, 18c and 19c: one instance ``name`` on ``COLD_NCOL`` columns
    (``policy_variant``: ``build_land_variant``'s cold column, its water-only
    LandModel or the implicit steppers on its soil; or its ``icy_state``),
    under ``stepper`` for ``steps`` steps where given (an explicit stepper's
    name; else ``policy_variant``'s), with per-column BC kinds and depths
    where ``columns`` (``with_columns``, the ``+kinds+B8`` instance), with
    ``rows`` (``policy_rows``,
    step-indexed or on ``time_grid``) or without, from t0 = 5 s, against the
    plain version (``check_variant``: the freeze bars of ``_check_freeze``
    after the launch's projections with freeze-thaw, else ``_check``; and
    ``_check_increment``, with ``carried_allowance``), the plain launch timed
    (host clock, synchronized) with its MOST solves counted
    (``_counting_solves``).  A freeze instance must grow ice in some columns
    and melt it in others, another leave theta_i alone.  Returns ``(error,
    shares, grown, melted, plain ms, MOST probes per solve or None)``."""
    model, Y, base, dt, base_steps = policy_variant(name, dtype, device)
    if columns:
        model = with_columns(model, COLUMNS_SEED)
    stepper = base if stepper is None else _stepper(stepper)
    steps = base_steps if steps is None else steps
    soil = getattr(model, "soil", model)
    if icy:
        Y = dict(Y, soil=icy_state(soil, Y)["soil"])
    forcing = policy_rows(model, steps if time_grid is None else time_grid[2], seed=37) if rows else None
    start = _np(Y)
    plain, _, probes, plain_ms = _counting_solves(lambda: ck.fused_column_run_plain(
        model, stepper, dt, steps, Y, 5.0, forcing=forcing, forcing_time_grid=time_grid))
    freeze = soil.freeze_thaw is not None
    check = (lambda a, b, d, w: _check_freeze(a, b, soil, d, w, steps)) if freeze else _check
    at = "" if isinstance(stepper, type(base)) else f"@{type(stepper).__name__}"
    what = f"{tag} cold {'icy ' if icy else ''}{str(dtype)[6:]} {name}{at}"
    moving = ("vartheta_l",) if "rho_e_int" not in start else ("vartheta_l", "rho_e_int")
    kern, _, shares = check_variant(ck, model, Y, dt, steps, 5.0, what, moving, stepper=stepper, check=check,
                                    plain=plain, increment_extra=carried_allowance(soil, dtype, steps),
                                    forcing=forcing, forcing_time_grid=time_grid)
    built = ck.make_fused_column_run(model, stepper, forcing_fields=tuple(forcing or ()),
                                     forcing_time_grid=time_grid).name
    name += "+kinds+B8" if columns else ""
    if built != name + ("" if not rows else "+B7" if time_grid is None else "+B7-time") + at:
        raise AssertionError(f"{what}: mode {built}")
    grown, melted = _ice_columns(kern, start)
    if freeze and not (grown and melted):
        raise AssertionError(f"{what}: ice grew in {grown} columns and melted in {melted}: "
                             "the phase change did not act")
    if not freeze and (grown or melted):
        raise AssertionError(f"{what}: theta_i changed in {grown + melted} columns without a phase change")
    return _max_abs(kern, _np(plain)), shares, grown, melted, plain_ms, probes


def cold_checks(ck, dtype, device):
    """16a: every instance of ``COLD_MODES`` (``cold_check``) with
    step-indexed forcing rows (``policy_rows``: theta_atm within 8 K of
    273.15 K under MOST, rain on a LandModel), the no-ice ones also on the
    icy state without rows.  Returns ``{name: (error, plain ms)}`` (the
    check with rows; 16c's and 17e's records carry them)."""
    out, lines = {}, []
    for name in COLD_MODES:
        err, shares, grown, melted, plain_ms, _ = cold_check(ck, name, dtype, device, rows=True)
        out[name] = (err, plain_ms)
        line = f"{name}+B7 {err:.2e} ({_fmt(shares)}; ice grew in {grown}, melted in {melted} columns)"
        if name.endswith("-no-ice"):
            err_icy, shares, _, _, _, _ = cold_check(ck, name, dtype, device, icy=True)
            out[name] = (max(err, err_icy), plain_ms)
            line += f", icy without rows {err_icy:.2e} ({_fmt(shares)})"
        lines.append(line)
    print(f"[16a cold] {str(dtype)[6:]} {len(COLD_MODES)} instances of land_policy_kernel.cu on {COLD_NCOL} columns "
          f"at 268-278 K with 0.02 of ice, {cold_steps(dtype)} steps of 2 s, with per-column forcing rows (theta_atm "
          "within 8 K "
          f"of 273.15 K under MOST, rain on a LandModel): kernel vs plain max abs, change error / largest change (bar "
          f"{INCREMENT_RTOL[dtype]:g}), columns where theta_i changed; the no-ice ones also on the icy state (theta_i "
          "0.05, vartheta_l = nu - 0.02 in the lower half) without rows: " + "; ".join(lines), flush=True)
    return out


def cold_path(ck, gc, costs, smi, dtype, device, name):
    """16b: one path at nz=64 x 65,536 (``build_cold_land``): one launch of
    ``COLD_WIDE_STEPS`` steps through ``Simulation(engine="fused")``
    (``drive_path``: launch counts set to 0 before and read after, the
    freeze bars after 32 projections and ``_check_increment`` with their
    carried allowance against the plain version), ice
    must form, and the column + pond water budget closes as in phase 10;
    the kernel timed with CUDA events (an untimed launch, then x3 twice),
    the plain version by its check's launch (host clock, synchronized, warm
    from 16a; it counts the MOST probes of the bound), the host share of the
    path's ``Simulation.run`` against the kernel time.  Returns the
    kernel record."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    model, Y0, Ya, dt = build_cold_land(gc, dtype, device, name)
    run = ck.make_fused_column_run(model, dt=dt, steps_per_call=COLD_WIDE_STEPS)
    if run.name != name:
        raise AssertionError(f"16b: mode {run.name}, expected {name}")
    key = _path_key(model, Y0, dt, COLD_WIDE_STEPS, SSPRK33())
    # no ice forms in the check's first steps: theta_i held to its finite change alone
    kern, launches, err, wall = drive_path(ck, model, Y0, Ya, dt, COLD_WIDE_STEPS, COLD_WIDE_STEPS, "16b cold",
                                           ("vartheta_l", "rho_e_int", "h_s"), projections=COLD_WIDE_STEPS,
                                           plain_steps=COLD_TIMED_STEPS)
    plain_ms, = _PATH_PLAIN_MS[key]
    probes = _PATH_PROBES[key][1] if run.mode & ck.MODE_MOST else None
    ice = float(np.max(kern["theta_i"]))
    if not ice > 1e-4:
        raise AssertionError(f"16b {name} {dtype}: no ice formed (max theta_i {ice})")
    dz = model.soil.domain.height / NZ
    end = {"soil": {k: torch.as_tensor(kern[k], device=device) for k in Y0["soil"]},
           "surface": {"h_s": torch.as_tensor(kern["h_s"], device=device)}}
    horizon = COLD_WIDE_STEPS * dt
    change = water_in(end, dz) - water_in(Y0, dz)
    rain = 8e-6 * horizon
    end = {g: {k: v.to(dtype) for k, v in f.items()} for g, f in end.items()}
    evap = 0.5 * (evaporation(model, Y0, 0.0) + evaporation(model, end, horizon)) * horizon
    budget = float((change - (rain - evap)).abs().max())
    if not budget < 1e-2 * rain:
        raise AssertionError(f"16b {name} {dtype}: water budget off by {budget:.3e} m of {rain:.3e} m of rain")
    Yk = _clone(Y0)
    run(Yk, 0.0)
    k1 = _time_ms(lambda: run(Yk, 0.0), 3)
    k2 = _time_ms(lambda: run(Yk, 0.0), 3)
    print(f"[16b cold] {str(dtype)[6:]} {name} nz={NZ} x {NCOL}, {COLD_WIDE_STEPS} steps of dt={dt:g}, theta_atm "
          f"{COLD_THETA_ATM} K: max theta_i {ice:.4e} (> 1e-4: ice formed) in "
          f"{int((kern['theta_i'].max(0) > 1e-6).sum())} columns; water budget (change of column water + h_s - "
          f"(rain - evaporation)) max abs {budget:.3e} m of {rain:.3e} m of rain; kernel {k1:.3f}/{k2:.3f} ms, plain "
          f"{plain_ms:.3f} ms (its check launch, one sample); Simulation.run {wall:.3f} ms, host share "
          f"{1.0 - (k1 + k2) / 2 / wall:.3f} on {smi}", flush=True)
    return time_record(ck, costs, smi, model, Y0, dt, COLD_WIDE_STEPS, SSPRK33(), launches, err, (k1, k2),
                       (plain_ms,), probes, tag="16b time")


def cold_probes(ck, model, Y0, dt, stepper=None, steps=COLD_TIMED_STEPS):
    """The mean probes per MOST solve and column of the plain version's
    launch of ``steps`` steps of ``stepper`` (SSPRK33 by default) on every
    ``COLD_PROBE_STRIDE``-th column of ``Y0`` (``most_probes`` on a
    ``column_slice``)."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    soil = getattr(model, "soil", model)
    idx = torch.arange(0, NCOL, COLD_PROBE_STRIDE, device=Y0["soil"]["vartheta_l"].device)
    sub, Ys = column_slice(soil, {"soil": Y0["soil"]}, idx)
    stepper = SSPRK33() if stepper is None else stepper
    if hasattr(stepper, "model"):
        stepper = dataclasses.replace(stepper, model=sub)
    if soil is not model:
        sub = dataclasses.replace(model, soil=sub)
        Ys["surface"] = {"h_s": Y0["surface"]["h_s"][idx].contiguous()}
    return most_probes(ck, sub, stepper, dt, steps, Ys)[1]


def time_cold(ck, gc, costs, smi, dtype, device, name, checked):
    """16c: one instance at nz=64 x 65,536 (``build_cold_land``), kernel
    only: an untimed launch of ``COLD_TIMED_STEPS`` steps, then two samples
    of three launches (CUDA events), the state finite after each; its bound
    with the MOST probes of ``cold_probes``.  The plain version is not timed
    here: the record carries 16a's plain launch (``checked``: ``(error,
    plain ms)`` on ``COLD_NCOL`` columns, ``COLD_STEPS`` steps) under
    ``plain_at``.  Returns the record and the probes (``None`` without
    MOST), which 17e reuses for the instance with rows."""
    model, Y0, _, dt = build_cold_land(gc, dtype, device, name)
    run = ck.make_fused_column_run(model, dt=dt, steps_per_call=COLD_TIMED_STEPS)
    Yk = _clone(Y0)
    run(Yk, 0.0)
    k1 = _time_ms(lambda: run(Yk, 0.0), 3)
    k2 = _time_ms(lambda: run(Yk, 0.0), 3)
    if not all(bool(torch.isfinite(v).all()) for f in Yk.values() for v in f.values()):
        raise AssertionError(f"16c {run.name} at nz={NZ} x {NCOL}: the state left the finite numbers")
    probes = cold_probes(ck, model, Y0, dt) if run.mode & ck.MODE_MOST else None
    ms = (k1 + k2) / 2
    b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, NZ * NCOL, COLD_TIMED_STEPS, ncol=NCOL, probes=probes)
    err, plain_ms = checked
    most = f"; MOST probes per solve {probes:.4f}" if probes is not None else ""
    print(f"[16c cold] {str(dtype)[6:]} {run.name} {COLD_TIMED_STEPS} steps of dt={dt:g} nz={NZ} ncol={NCOL}: kernel "
          f"{k1:.3f}/{k2:.3f} ms ({NZ * NCOL * COLD_TIMED_STEPS / (ms / 1e3):.4e} grid-points/s), plain not timed, "
          f"bound {b_ms:.3f} ms by {b_by} ({b_ms / ms:.3f} of the kernel's time){most} on {smi}", flush=True)
    kernel, source = kernel_of(ck, run.mode, dtype)
    return {"name": f"{kernel}<{str(dtype)[6:].replace('float', 'f')}, {run.name}>", "route": "cuda",
            "source": source, "replaces": REPLACES, "launches": 1, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "plain_at": f"16a: nz=16 x {COLD_NCOL}, {cold_steps(dtype)} steps, with rows",
            "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}, probes


def cold_phase(ck, costs, smi, device, t_start):
    """Phase 16: 16a's checks of every new instance (``cold_checks``), 16b's
    three paths at width (``cold_path``), 16c's time of every instance at
    width but the paths' (``time_cold``).  Returns the kernel records,
    16a's checks ``{dtype: {name: (error, plain ms)}}`` and 16c's MOST
    probes ``{(dtype, name): probes}`` (phase 17 reads both)."""
    gc = _load_golden_config()
    entries, checks, probes = [], {}, {}
    for dtype in (torch.float64, torch.float32):
        checked = checks[dtype] = cold_checks(ck, dtype, device)
        _mark(t_start, f"phase 16a's {str(dtype)[6:]} checks")
        for name in COLD_PATHS:
            entries.append(cold_path(ck, gc, costs, smi, dtype, device, name))
            torch.cuda.empty_cache()
        _mark(t_start, f"phase 16b's {str(dtype)[6:]} paths")
        for name in COLD_MODES:
            if name not in COLD_PATHS:
                record, probes[(dtype, name)] = time_cold(ck, gc, costs, smi, dtype, device, name, checked[name])
                entries.append(record)
        torch.cuda.empty_cache()
        _mark(t_start, f"phase 16c's {str(dtype)[6:]} times")
    return entries, checks, probes


# ---- phase 17: cold forced and water-only land: the step policies with forcing rows, the water-only
# LandModel, the implicit steppers' step policies under a MOST top ----

#: 17a: the water-only LandModel's instances (csrc/land_kernel.cu; the no-ice ones csrc/land_policy_kernel.cu)
WATER_MODES = tuple(lag + top + "-water" + ice for top in ("B6-pond", "B6-step-pond") for lag in ("", "B2+")
                    for ice in ("", "-no-ice"))
#: the implicit steppers' mode names, and their step policies (the name's suffix before ``+B5``)
IMPLICIT_STEPPERS = {"B4-trbdf2": "TRBDF2Soil", "B4-be-soil": "BackwardEulerSoil",
                     "B4-be-richards": "BackwardEulerRichards"}
IMPLICIT_POLICIES = ("+B2", "+B3-rate", "+B3-eq", "-no-ice", "+B2+B3-rate", "+B2+B3-eq", "-no-ice+B2")
#: the implicit instances: under a MOST top with each policy (csrc/implicit_most_kernel.cu), and lagged
#: with no ice on the plain soil (csrc/implicit_kernel.cu)
IMPLICIT_MODES = (tuple(st + p + "+B5" for st in IMPLICIT_STEPPERS for p in IMPLICIT_POLICIES)
                  + tuple(st + "-no-ice+B2" for st in IMPLICIT_STEPPERS))
#: 17a: the implicit instances' dt and steps on the cold column (two steps, not COLD_STEPS: a cut for the
#: script's time), and the two also checked with forcing rows
IMPLICIT_DT, IMPLICIT_STEPS = 60.0, 2
IMPLICIT_ROW_MODES = ("B4-trbdf2+B3-rate+B5", "B4-trbdf2+B2+B3-eq+B5")
#: 17a: the MOST tops' rate instances checked with time-indexed rows too
COLD_TIME_MODES = ("B5+B3-rate", "B6+B3-rate", "B6-step+B3-rate")
#: 17a's time grids (t_start, dt_forcing, rows) from t0 = 5 s: the SSPRK33 instances' four steps of 2 s
#: read rows 0, 1, 3, 3 (two steps in f64: rows 0, 1); the implicit ones' two of 60 s rows 0, 1
COLD_TIME_GRID, IMPLICIT_TIME_GRID = (4.5, 1.5, 4), (0.0, 50.0, 3)
#: 17b: ``forced_reanalysis.py``'s forcing with theta_atm lowered by COLD_FORCED_SHIFT (to 270 +- 8 K), under
#: FreezeThaw(tau), in the reference and production settings: 48 of its 1,440 steps in two windows.  Cut from
#: 240: from step 70-74 the rain band falls on frozen top cells, whose potential infiltration sees the face
#: saturated at nu over their ice (psi = theta_i / S_s), so the top cell saturates past the explicit limit of
#: dt = 120 s and leaves the finite numbers, in the JAX package's forced segment as in the port's plain
#: version (tests/test_torch_cold_forced_divergence.py)
COLD_FORCED_STEPS, COLD_FORCED_WINDOW, COLD_FORCED_SHIFT, COLD_FORCED_TAU = 48, 24, 24.0, 3600.0
COLD_FORCED_PATHS = ("B6+B3-rate", "B2+B6-step+B3-rate")
#: 17c: ``catchment.py``'s storm on a 512 x 512 grid (no routing, a uniform 2 m depth), 32 steps of 2 s
#: from t0 = 1,700 s in one launch; the plain version on every STORM_STRIDE-th column
STORM_NZ, STORM_SIDE, STORM_DT, STORM_STEPS, STORM_T0, STORM_STRIDE = 16, 512, 2.0, 32, 1700.0, 256
STORM_PATHS = ("B6-pond-water", "B2+B6-step-pond-water")
#: 17d: TR-BDF2 under the cold MOST top at nz=64 x 65,536, one launch of 8 steps of IMPLICIT_DT; the second in f64
#: held to the plain version by a launch of IMPLICIT_STEPS steps (phase 19's cut of plain launches)
COLD_IMPLICIT_PATHS = ("B4-trbdf2+B3-rate+B5", "B4-trbdf2+B2+B3-eq+B5")
COLD_IMPLICIT_STEPS = 8


def build_water_variant(ncol, dtype, device, seed, case):
    """17a: ``build_land_variant``'s LandModel under its plain top (``case``
    names it, ``-water`` after the top) on a water-only soil: T prescribed
    as 275 K + 3 K/m z, ``TemperatureDependentViscosity``, zero water flux at
    both faces, no ice; ``-no-ice`` sets ``assume_no_ice``."""
    from landhydrology_tpu_torch import PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC, VerticalFlux
    from landhydrology_tpu_torch.models.soil import TemperatureDependentViscosity

    land, Y = build_land_variant(ncol, dtype, device, seed, case.replace("-water", "").replace("-no-ice", ""))
    soil = land.soil
    water = dataclasses.replace(
        soil, energy_model=PrescribedTemperatureModel(T_profile=lambda z, t: 275.0 + 3.0 * z),
        hydrology_model=dataclasses.replace(soil.hydrology_model, viscosity_factor=TemperatureDependentViscosity()),
        assume_no_ice=case.endswith("-no-ice"),
        boundary_conditions=SoilColumnBC(top=SoilComponentBC(hydrology=VerticalFlux(0.0)),
                                         bottom=SoilComponentBC(hydrology=VerticalFlux(0.0))))
    state = {"vartheta_l": Y["soil"]["vartheta_l"], "theta_i": torch.zeros_like(Y["soil"]["theta_i"])}
    return dataclasses.replace(land, soil=water), {"soil": state, "surface": Y["surface"]}


def implicit_case(name):
    """``(stepper class name, the cold land case of its soil)`` of an
    implicit instance: ``B4-be-soil-no-ice+B2+B5`` -> (``BackwardEulerSoil``,
    ``B2+B5-no-ice``); the plain soil's lagged no-ice ones take the pond
    variant's soil (``B2+B6-pond-no-ice``)."""
    stepper = next(k for k in IMPLICIT_STEPPERS if name.startswith(k + "+") or name.startswith(k + "-"))
    rest = name[len(stepper):]
    policy = next((p for p in ("+B3-rate", "+B3-eq") if p in rest), "-no-ice" if "-no-ice" in rest else "")
    top = "B5" if rest.endswith("+B5") else "B6-pond"
    return IMPLICIT_STEPPERS[stepper], ("B2+" if "+B2" in rest else "") + top + policy


def cold_steps(dtype):
    """Steps of a 16a or 17a check of an explicit instance in ``dtype``."""
    return COLD_STEPS_F64 if dtype == torch.float64 else COLD_STEPS


def policy_variant(name, dtype, device):
    """``(model, state, stepper, dt, steps)`` of 16a's and 17a's check of
    instance ``name`` on ``COLD_NCOL`` columns: ``build_land_variant``'s cold
    column (``cold_steps`` steps of 2 s), its water-only LandModel
    (``build_water_variant``), or an implicit stepper on its soil under the
    cold MOST atmosphere or the plain top (``IMPLICIT_STEPS`` steps of
    ``IMPLICIT_DT``)."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    if name.startswith("B4-"):
        stepper, case = implicit_case(name)
        model, Y = build_land_variant(COLD_NCOL, dtype, device, seed=29, case=case, cold=True)
        soil = getattr(model, "soil", model)
        return soil, {"soil": Y["soil"]}, implicit(stepper, soil, 2), IMPLICIT_DT, IMPLICIT_STEPS
    if "-water" in name:
        model, Y = build_water_variant(COLD_NCOL, dtype, device, 29, name)
        return model, Y, SSPRK33(), 2.0, cold_steps(dtype)
    model, Y = build_land_variant(COLD_NCOL, dtype, device, seed=29, case=name, cold=True)
    return model, Y, SSPRK33(), 2.0, cold_steps(dtype)


def policy_rows(model, n_rows, seed):
    """Forcing rows of a 17a check, ``(n_rows, ncol)`` each: ``theta_atm``
    within 8 K of 273.15 K under a MOST top, a rain rate of 0-1.2e-5 m/s on
    a LandModel."""
    from landhydrology_tpu_torch import PrescribedAtmosForcing

    soil = getattr(model, "soil", model)
    ncol = soil.domain.batch_shape[0]
    rng = np.random.default_rng(seed)
    tensor = lambda x: torch.as_tensor(x, dtype=soil.float_dtype, device=soil.device)  # noqa: E731
    rows = {}
    if isinstance(soil.boundary_conditions.top, PrescribedAtmosForcing):
        rows["theta_atm"] = tensor(273.15 + rng.uniform(-8.0, 8.0, (n_rows, ncol)))
    if soil is not model:
        rows["precipitation"] = tensor(rng.uniform(0.0, 1.2e-5, (n_rows, ncol)))
    return rows


def cold_forced_checks(ck, dtype, device):
    """17a: the MOST tops' rate instances with time-indexed rows (16a holds
    the 30 land policy instances with step-indexed rows), the 8 water-only
    ones with and without rain rows, the 24 implicit ones (two with both row
    kinds); the new no-ice instances also on the icy state (``cold_check``
    each).  Returns ``{name: (error, plain ms)}`` of the new instances'
    checks without rows."""
    out, lines = {}, []
    cases = ([(name, dict(rows=True, time_grid=COLD_TIME_GRID)) for name in COLD_TIME_MODES]
             + [(name, kw) for name in WATER_MODES for kw in (dict(), dict(rows=True))]
             + [(name, dict()) for name in IMPLICIT_MODES]
             + [(name, dict(rows=True, time_grid=grid)) for name in IMPLICIT_ROW_MODES
                for grid in (None, IMPLICIT_TIME_GRID)])
    for name, kw in cases:
        new = not kw
        for icy in (False, True) if new and "no-ice" in name else (False,):
            err, shares, grown, melted, plain_ms, _ = cold_check(ck, name, dtype, device, icy=icy, tag="17a", **kw)
            rows = "" if not kw else " +B7" if kw.get("time_grid") is None else " +B7-time"
            lines.append(f"{name}{rows}{' icy' if icy else ''} {err:.2e} ({_fmt(shares)}; ice grew in {grown}, "
                         f"melted in {melted})")
            if new:
                old_err, old_ms = out.get(name, (0.0, plain_ms))
                out[name] = (max(err, old_err), old_ms)
    print(f"[17a cold forced] {str(dtype)[6:]} {len(cases)} checks on {COLD_NCOL} columns at 268-278 K with 0.02 "
          f"of ice, {cold_steps(dtype)} steps of 2 s (the implicit ones {IMPLICIT_STEPS} of {IMPLICIT_DT:g} s): the MOST "
          "tops' "
          "rate instances with "
          "time-indexed theta_atm rows within 8 K of 273.15 K (and rain rows), the water-only LandModel (T 270-275 K "
          "prescribed, viscosity, no ice) with and without rain rows, the implicit steppers' policy instances; the "
          "new no-ice ones also on the icy state: kernel vs plain max abs (change error / largest change, bar "
          f"{INCREMENT_RTOL[dtype]:g}; columns where theta_i changed): " + "; ".join(lines), flush=True)
    return out


def build_cold_reanalysis(nz, ncol, dtype, device, setting):
    """17b: ``build_reanalysis``'s LandModel under ``FreezeThaw(tau=
    COLD_FORCED_TAU)`` in ``setting`` (``B6+B3-rate``, or the production
    ``B2+B6-step+B3-rate``: the frozen exchange and lagged coefficients),
    its soil at ``build_freeze_wide``'s temperatures (273.4-275.4 K by
    column) with its water (0.18) and no pond."""
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil.freeze_thaw import FreezeThaw
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy

    land, Y, Ya = build_reanalysis(nz, ncol, dtype, device)
    production = setting.startswith("B2+")
    soil = dataclasses.replace(land.soil, freeze_thaw=FreezeThaw(tau=COLD_FORCED_TAU),
                               coefficient_update="step" if production else "stage")
    land = dataclasses.replace(land, soil=soil, surface_update="step" if production else "stage")
    theta, theta_i = Y["soil"]["vartheta_l"], Y["soil"]["theta_i"]
    T = (273.4 + 2.0 * torch.arange(ncol, dtype=dtype, device=device)[None, :] / ncol).expand(nz, ncol)
    rho_c_s = volumetric_heat_capacity(theta, theta_i, 1.3e6, ps)
    Y["soil"]["rho_e_int"] = volumetric_internal_energy(theta_i, rho_c_s, T, ps).contiguous()
    return land, Y, Ya


def cold_forced_path(ck, costs, smi, dtype, device, setting, path):
    """17b: the cold season's forced reanalysis at full width
    (``build_cold_reanalysis``, nz=24 x 131,072) in ``setting``:
    ``COLD_FORCED_STEPS`` rows from the file at ``path`` in windows of
    ``COLD_FORCED_WINDOW`` through ``run_forced`` (``FORCED_SPC`` steps per
    launch), with the launch counts
    set to 0 just before it and read just after; equal bit for bit to the
    in-memory segment launch by launch, whose first launch is held to the
    plain version on every ``FORCED_STRIDE``-th column (the freeze bars of
    ``_check_freeze``, ``_check_increment``; its MOST probes counted for the
    bound); ice must form; the column + pond water budget closes
    (``check_budget``).  The kernel timed by CUDA events, the reader's and
    the host's share of the run's wall time printed.  Returns its kernel
    record."""
    from landhydrology_tpu_torch.runtime import ForcingReader, make_forced_segment_run, run_forced
    from landhydrology_tpu_torch.timestepping import SSPRK33

    nz, ncol, dt, spc, n = FORCED_NZ, FORCED_NCOL, FORCED_DT, FORCED_SPC, COLD_FORCED_STEPS
    tag = str(dtype)[6:]
    what = f"17b cold forced {tag} {setting}"
    land, Y0, Ya = build_cold_reanalysis(nz, ncol, dtype, device, setting)
    with ForcingReader(path) as reader:
        fields = list(reader.field_names)
        block = np.empty((n, len(fields), ncol), dtype=reader.dtype)
        reader.read_into(0, n, block)
    rows = {k: torch.from_numpy(block[:, j]).to(device).to(dtype) for j, k in enumerate(fields)}
    del block
    name = f"{setting}+B7"
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    clock = time.perf_counter()
    with ForcingReader(path) as base:
        reader = TimedReader(base)
        Yf, tf = run_forced(land, Y0, Ya, reader, SSPRK33(), dt=dt, window=COLD_FORCED_WINDOW, engine="fused",
                            steps_per_call=spc)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - clock) * 1e3
    launches = dict(ck.LAUNCHES)
    if launches != {name: n // spc}:
        raise AssertionError(f"{what}: launches {launches}, expected {n // spc} of {name}")
    seg = make_forced_segment_run(land, SSPRK33(), dt=dt, field_names=fields, engine="fused", steps_per_call=spc)
    Yc, kept, evap = launch_by_launch(lambda Y, t, r: seg(Y, Ya, t, r), land, Y0, rows, dt, spc, keep=(0,))
    for g, f in Yc.items():
        for k, v in f.items():
            if not torch.equal(Yf[g][k], v):
                raise AssertionError(f"{what}: run_forced differs from the segment launch by launch in {k}")
    cols = torch.arange(0, ncol, FORCED_STRIDE, device=device)
    sub, Ys = column_slice(land.soil, {"soil": Y0["soil"]}, cols)
    Ys["surface"] = {"h_s": Y0["surface"]["h_s"][cols].contiguous()}
    small = dataclasses.replace(land, soil=sub)
    r_cols = {k: v[:spc, cols].contiguous() for k, v in rows.items()}
    plain, _, probes, plain_ms = _counting_solves(lambda: forced_plain(ck, small, dt, spc, Ys, 0.0, r_cols))
    plain = _np(plain)
    kern = {k: v[..., cols.cpu().numpy()] for k, v in _np(kept[0]).items()}
    _check_freeze(kern, plain, land.soil, dtype, what)
    shares = _check_increment(kern, plain, _np(Ys), dtype, what, ("vartheta_l", "rho_e_int"))
    end = _np(Yf)
    ice_cols = int((end["theta_i"].max(0) > 1e-6).sum())
    if not float(np.max(end["theta_i"])) > 1e-4:
        raise AssertionError(f"{what}: no ice formed (max theta_i {float(np.max(end['theta_i']))})")
    change, rain_max, evap_mean, residual = check_budget(land, Y0, Yf, rows, dt, evap, what)
    run = ck.make_fused_column_run(land, SSPRK33(), dt=dt, steps_per_call=spc, forcing_fields=tuple(fields))
    chunk = {k: v[:spc] for k, v in rows.items()}
    Yk = _clone(Y0)
    run(Yk, 0.0, forcing=chunk)
    k1, k2 = _time_ms(lambda: run(Yk, 0.0, forcing=chunk), 3), _time_ms(lambda: run(Yk, 0.0, forcing=chunk), 3)
    k_ms = (k1 + k2) / 2
    b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, nz * ncol, spc, ncol=ncol, probes=probes,
                          read_values=len(fields) * spc * ncol)
    read = sum(reader.read_ms)
    print(f"[17b cold forced] {tag} {name} nz={nz} x {ncol}, {n} steps of dt={dt:g} (theta_atm {COLD_FORCED_SHIFT:g} K "
          f"below the experiment's, FreezeThaw tau {COLD_FORCED_TAU:g} s) through run_forced from the file, windows "
          f"of {COLD_FORCED_WINDOW} ({launches[name]} launches): equal bit for bit to the segment launch by launch; every {FORCED_STRIDE}th "
          f"column's first launch vs plain max abs {_max_abs(kern, plain):.3e}, change error / largest change "
          f"{_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g}); max theta_i {float(np.max(end['theta_i'])):.4e} (ice in "
          f"{ice_cols} columns); water budget: change {change:.6e} m (mean), largest rain {rain_max:.6e} m, "
          f"evaporation {evap_mean:.6e} m (mean), largest residual {residual:.3e} m; wall {wall:.3f} ms "
          f"({nz * ncol * n / (wall / 1e3):.4e} grid-points/s), kernel {k1:.3f}/{k2:.3f} ms per launch (plain "
          f"{plain_ms:.3f} ms on {cols.numel()} columns, bound {b_ms:.3f} ms by {b_by}, MOST probes per solve "
          f"{probes:.4f}); reader share {read / wall:.3f}, host share {1.0 - launches[name] * k_ms / wall:.3f} on "
          f"{smi}", flush=True)
    entry = forced_entry(ck, run, dtype, launches[name], _max_abs(kern, plain), k_ms, plain_ms, b_ms, b_by)
    entry["plain_at"] = f"17b: nz={nz} x {cols.numel()} columns, {spc} steps"
    return entry


def storm_precipitation(t):
    """``catchment.py``'s storm for its default 2 h run: a Gaussian pulse of
    40 mm/h at t = 1,800 s, width 576 s (m/s, in t's dtype)."""
    return (40.0 / 1000.0 / 3600.0) * torch.exp(-(((t - 1800.0) / 576.0) ** 2))


def build_storm(dtype, device, case, side=None, variable_depth=False, atmos=False):
    """17c and 19a-b: ``experiments/soil/catchment.py:87-180``'s soil on a
    ``side`` x ``side`` grid, flattened (columns in row-major order): the
    ridge/valley terrain's per-column vanGenuchten (n 1.8-3.0, alpha
    2.0-3.5, Ksat 10**(-6.5 + 1.2 z_norm + noise), theta_r 0.05;
    ``default_rng(42)``), nu 0.42, S_s 1e-3, zero-flux bedrock, T
    prescribed; its storm (``storm_precipitation``), tau_pond 600 s; water
    0.15, no ice, no pond.  Cut: no routing (a cross-column stencil, eager
    only in both packages).  17c runs a uniform 2 m depth (the
    instances without ``MODE_COLUMNS``); ``variable_depth`` (19a) the
    regolith of ``catchment.py:99``, 0.5 m on the ridge to 2 m in the valley
    (a ``VariableDepthColumn``, kernel mode B8); ``atmos`` (19b) its
    ``--atmos`` soil (``:112-118``, ``:177-178``): coupled, under its MOST
    top, zero-flux energy below, 292 K.  ``case``: ``B6-pond-water`` and its
    lagged / frozen-exchange / no-ice names, or with ``atmos`` ``B6``,
    ``B2+B6-step``, ....  Returns ``(land, state)``."""
    side = STORM_SIDE if side is None else side
    from landhydrology_tpu_torch import (
        Column, PrescribedAtmosForcing, PrescribedTemperatureModel, SoilColumnBC, SoilComponentBC, SoilEnergyModel,
        SoilHydrologyModel, SoilModel, SoilParams, VariableDepthColumn, VerticalFlux,
    )
    from landhydrology_tpu_torch.constants import default_earth_param_set as ps
    from landhydrology_tpu_torch.models.soil.heat import volumetric_heat_capacity, volumetric_internal_energy
    from landhydrology_tpu_torch.models.land import LandModel, SurfaceWaterModel
    from landhydrology_tpu_torch.models.soil import vanGenuchten

    ix, iy = np.arange(side)[:, None], np.arange(side)[None, :]
    z = 4.0 * (1.0 + np.cos(2 * np.pi * ix / side)) * np.ones((1, side)) + 0.3 * np.sin(
        2 * np.pi * iy / side) * np.sin(2 * np.pi * ix / side)
    z_norm = ((z - z.min()) / (z.max() - z.min())).reshape(-1)
    log_ksat = -6.5 + 1.2 * z_norm + 0.15 * np.random.default_rng(42).standard_normal(side * side)
    tensor = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    hm = vanGenuchten(n=tensor(1.8 + 1.2 * z_norm), alpha=tensor(2.0 + 1.5 * z_norm), Ksat=tensor(10.0 ** log_ksat),
                      theta_r=0.05)
    ncol = side * side
    domain = Column(zlim=(-2.0, 0.0), nelements=STORM_NZ, batch_shape=(ncol,))
    if variable_depth:
        domain = VariableDepthColumn(z_bottom=-(0.5 + 1.5 * (1.0 - z_norm)), nelements=STORM_NZ, batch_shape=(ncol,))
    energy, top = PrescribedTemperatureModel(), SoilComponentBC(hydrology=VerticalFlux(0.0))
    bottom = SoilComponentBC(hydrology=VerticalFlux(0.0))
    if atmos:
        energy = SoilEnergyModel()
        top = PrescribedAtmosForcing(u_atm=2.0, theta_atm=300.0, z_atm=2.0, theta_scale=300.0, rho_a_sfc=1.2,
                                     q_atm=0.006)
        bottom = SoilComponentBC(hydrology=VerticalFlux(0.0), energy=VerticalFlux(0.0))
    soil = SoilModel(
        domain=domain, energy_model=energy, hydrology_model=SoilHydrologyModel(hydraulic_model=hm),
        boundary_conditions=SoilColumnBC(top=top, bottom=bottom),
        soil_param_set=SoilParams(nu=0.42, S_s=1e-3, rho_c_ds=1.3e6), dtype=dtype, device=device,
        coefficient_update="step" if case.startswith("B2+") else "stage", assume_no_ice=case.endswith("-no-ice"),
    )
    land = LandModel(soil=soil, surface=SurfaceWaterModel(precipitation=storm_precipitation, tau_pond=600.0),
                     surface_update="step" if "-step" in case else "stage")
    theta = torch.full((STORM_NZ, ncol), 0.15, dtype=dtype, device=device)
    state = {"vartheta_l": theta, "theta_i": torch.zeros_like(theta)}
    if atmos:
        rho_c_s = volumetric_heat_capacity(theta, state["theta_i"], 1.3e6, ps)
        state["rho_e_int"] = volumetric_internal_energy(state["theta_i"], rho_c_s, torch.full_like(theta, 292.0), ps)
    return land, {"soil": state, "surface": {"h_s": torch.zeros(ncol, dtype=dtype, device=device)}}


def storm_path(ck, costs, smi, dtype, device, case, variable_depth=False, atmos=False, tag="17c"):
    """17c and 19a-b: the storm at width (``build_storm``, nz=16 x 262,144;
    19a at catchment.py's regolith depth, 19b its ``--atmos`` soil there):
    one launch of ``STORM_STEPS`` steps from ``STORM_T0`` through
    ``Simulation(engine="fused")``, the launch counts set to 0 just before
    it and read just after; every ``STORM_STRIDE``-th column held to the
    plain version (``_check``, ``_check_increment``); a pond must form; on
    the water-only soil the column + pond water (each column's dz) equals
    the storm's rain over the launch as SSPRK33 integrates it (weights 1/6,
    1/6, 2/3 at t, t + dt, t + dt/2) within ``BUDGET_SHARE`` of the largest
    column's (under MOST the exchange also evaporates, so 19b holds the
    state to the plain version alone); the kernel timed by CUDA events, and
    the host's share of the run's wall time.  Returns its kernel record."""
    from landhydrology_tpu_torch import Simulation
    from landhydrology_tpu_torch.domains import make_function_space
    from landhydrology_tpu_torch.timestepping import SSPRK33

    dname = str(dtype)[6:]
    land, Y0 = build_storm(dtype, device, case, variable_depth=variable_depth, atmos=atmos)
    nz, ncol, dt, n = STORM_NZ, STORM_SIDE ** 2, STORM_DT, STORM_STEPS
    name = case + ("+B8" if variable_depth else "")
    what = f"{tag} storm {dname} {name}"
    grid = make_function_space(land.soil.domain, dtype, device)
    Ya = {"zc": grid.zc, "soil": {}}
    sim = Simulation(land, SSPRK33(), Y_init=Y0, Ya_init=Ya, dt=dt, tspan=(STORM_T0, STORM_T0 + n * dt),
                     engine="fused", steps_per_call=n)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    clock = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - clock) * 1e3
    launches = dict(ck.LAUNCHES)
    if launches != {name: 1}:
        raise AssertionError(f"{what}: launches {launches}, expected one of {name}")
    end = sim.Y
    cols = torch.arange(0, ncol, STORM_STRIDE, device=device)
    sub, Ys = column_slice(land.soil, {"soil": Y0["soil"]}, cols)
    Ys["surface"] = {"h_s": Y0["surface"]["h_s"][cols].contiguous()}
    small = dataclasses.replace(land, soil=sub)
    plain, _, probes, plain_ms = _counting_solves(lambda: ck.fused_column_run_plain(small, SSPRK33(), dt, n, Ys,
                                                                                     STORM_T0))
    plain = _np(plain)
    kern = {k: v[..., cols.cpu().numpy()] for k, v in _np(end).items()}
    # in f32 a pond that forms in the launch carries the f32 spread of the potential infiltration, which
    # the wet top cell's pressure head takes from a difference near saturation: the pond is held by its
    # change bar (_check_increment) there, as _check_freeze holds a pond after several projections
    _check(kern if dtype == torch.float64 else {k: v for k, v in kern.items() if k != "h_s"}, plain, dtype, what)
    moving = ("vartheta_l", "rho_e_int", "h_s") if atmos else ("vartheta_l", "h_s")
    shares = _check_increment(kern, plain, _np(Ys), dtype, what, moving)
    h = end["surface"]["h_s"]
    ponded = int((h > 1e-6).sum())
    if not ponded:
        raise AssertionError(f"{what}: no pond formed (max h_s {float(h.max())})")
    budget = "under MOST the exchange evaporates: no rain budget"
    if not atmos:
        t = STORM_T0 + dt * torch.arange(n, dtype=torch.float64)
        rain = float((dt * (storm_precipitation(t) / 6 + storm_precipitation(t + dt) / 6
                            + 2 * storm_precipitation(t + dt / 2) / 3)).sum())
        dz = grid.dz.reshape(-1) if torch.is_tensor(grid.dz) else grid.dz
        change = water_in(end, dz) - water_in(Y0, dz)
        residual = float((change - rain).abs().max())
        if not residual <= BUDGET_SHARE * rain:
            raise AssertionError(f"{what}: water budget residual {residual:.3e} m of {rain:.3e} m of rain")
        budget = (f"water budget (each column's dz): rain {rain:.6e} m, largest residual {residual:.3e} m (bar "
                  f"{BUDGET_SHARE:g} of the rain)")
    run = ck.make_fused_column_run(land, SSPRK33(), dt=dt, steps_per_call=n)
    Yk = _clone(Y0)
    run(Yk, STORM_T0)
    k1, k2 = (_time_ms(lambda: run(Yk, STORM_T0), 3) for _ in range(2))
    b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, nz * ncol, n, ncol=ncol, probes=probes,
                          read_values=per_column_values(run, nz, ncol, dtype))
    ms = (k1 + k2) / 2
    depth = "catchment.py's regolith depth, 0.5-2 m" if variable_depth else "a uniform 2 m depth"
    soil = "its --atmos soil under MOST from 292 K" if atmos else "catchment.py's soil"
    print(f"[{tag} storm] {dname} {name} {soil} and storm on {STORM_SIDE} x {STORM_SIDE} columns, nz={nz}, "
          f"{n} steps of dt={dt:g} from t0={STORM_T0:g} s (no routing, {depth}): launches {launches}; "
          f"every {STORM_STRIDE}th column vs plain max abs {_max_abs(kern, plain):.3e} (h_s "
          f"{float(np.max(np.abs(kern['h_s'] - plain['h_s']))):.3e} m), change error / largest change "
          f"{_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g}); a pond in {ponded} columns (max h_s "
          f"{float(h.max()):.4e} m); {budget}; Simulation.run {wall:.3f} ms, kernel {k1:.3f}/{k2:.3f} ms "
          f"({nz * ncol * n / (ms / 1e3):.4e} grid-points/s; host share of the run {max(wall - ms, 0.0) / wall:.3f}), "
          f"plain {plain_ms:.3f} ms on {cols.numel()} columns, bound {b_ms:.3f} ms by {b_by}"
          + (f" (MOST probes per solve {probes:.4f})" if probes is not None else "") + f" on {smi}", flush=True)
    kernel, source = kernel_of(ck, run.mode, dtype)
    return {"name": f"{kernel}<{dname.replace('float', 'f')}, {name}>", "route": "cuda", "source": source,
            "replaces": REPLACES, "launches": launches[name], "max_abs_err": _max_abs(kern, plain),
            "ms": ms, "plain_ms": plain_ms,
            "plain_at": f"{tag}: nz={nz} x {cols.numel()} columns, {n} steps", "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def cold_implicit_path(ck, gc, dtype, device, name):
    """17d: TR-BDF2 under the cold MOST top at width (``build_cold_land``'s
    soil, nz=64 x 65,536, theta_atm ``COLD_THETA_ATM``) in instance ``name``:
    one launch of ``COLD_IMPLICIT_STEPS`` steps of ``IMPLICIT_DT`` through
    ``Simulation(engine="fused")`` held to the plain version
    (``drive_path``: the freeze bars after as many projections, and the
    change bar; in f32 an equilibrium path's change bar holds the
    quantities the projection does not re-partition, ``unpartitioned``);
    ice must form.  Returns the path for phase 6's times."""
    stepper, case = implicit_case(name)
    soil, Y0, Ya, _ = build_cold_land(gc, dtype, device, case)
    st = implicit(stepper, soil, 2)
    n = COLD_IMPLICIT_STEPS
    change_of, moving = None, ("vartheta_l", "rho_e_int")
    if dtype == torch.float32 and _projection_allowance(soil, dtype)[0]:
        # an f32 projection partitions a cell whose T lies within an ulp of T_eq either way, by up to
        # _check_freeze's allowance (2.9e-3 of vartheta_l here), near the launch's largest change of
        # vartheta_l and theta_i: their spread is held by _check_freeze's state bars, and the change bar
        # (0.1 of the change, each quantity moving) by the total water and rho_e_int, which no
        # projection moves
        change_of, moving = unpartitioned(soil), ("water", "rho_e_int")
    kern, launches, err, wall = drive_path(ck, soil, Y0, Ya, IMPLICIT_DT, n, n, "17d cold implicit", moving,
                                           stepper=st, projections=n, change_of=change_of,
                                           plain_steps=IMPLICIT_STEPS if dtype == torch.float64 else None)
    ice = float(np.max(kern["theta_i"]))
    if not ice > 1e-4:
        raise AssertionError(f"17d {name} {dtype}: no ice formed (max theta_i {ice})")
    print(f"[17d cold implicit] {str(dtype)[6:]} {name} nz={NZ} x {NCOL}, {n} steps of dt={IMPLICIT_DT:g}, theta_atm "
          f"{COLD_THETA_ATM} K: max theta_i {ice:.4e} (> 1e-4: ice formed) in "
          f"{int((kern['theta_i'].max(0) > 1e-6).sum())} columns; Simulation.run {wall:.3f} ms", flush=True)
    return soil, Y0, IMPLICIT_DT, n, launches, err, st


def unpartitioned(soil):
    """Maps an ``_np`` state to what an equilibrium projection leaves as it
    was (``freeze_thaw.equilibrium_phase_projection``): the total water
    vartheta_l + theta_i rho_i / rho_l, and rho_e_int (and the pond)."""
    ratio = soil.earth_param_set.rho_cloud_ice / soil.earth_param_set.rho_cloud_liq

    def fields(Y):
        out = {"water": Y["vartheta_l"] + ratio * Y["theta_i"], "rho_e_int": Y["rho_e_int"]}
        return dict(out, h_s=Y["h_s"]) if "h_s" in Y else out

    return fields


def time_at_width(ck, costs, smi, model, Y0, stepper, dt, t0, name, checked, forcing=None, probes=None,
                  steps=COLD_TIMED_STEPS, tag="17e", plain_at=None, from_start=False):
    """17e, 18c and 18d: one instance kernel only, at its path's width (18c
    at 16c's and 17c's, 18d at 18a's): an untimed launch of ``steps``
    steps, then two samples of three launches (CUDA events), the state
    finite after each; its bound, a MOST instance's with the probes of
    ``cold_probes`` (or ``probes``), the rows read once (``forcing``); with
    ``from_start`` (20d) an untimed launch and two samples of one launch,
    each from the start state, as phase 12 times its variants.  The record
    carries the instance's check (``checked``: ``(error, plain ms)``; 17a's
    on ``COLD_NCOL`` columns by default) under ``plain_at``."""
    dtype = model.float_dtype
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=steps, forcing_fields=tuple(forcing or ()))
    if run.name != name:
        raise AssertionError(f"{tag}: built {run.name}, expected {name}")
    if from_start:
        k1, k2 = _from_start_ms(run, Y0, t0, forcing, f"{tag} {name}")
    else:
        Yk = _clone(Y0)
        run(Yk, t0, forcing=forcing)
        k1, k2 = (_time_ms(lambda: run(Yk, t0, forcing=forcing), 3) for _ in range(2))
        if not all(bool(torch.isfinite(v).all()) for f in Yk.values() for v in f.values()):
            raise AssertionError(f"{tag} {name}: the state left the finite numbers")
        del Yk
    if run.mode & ck.MODE_MOST and probes is None:  # the implicit steppers' over one step
        probes = cold_probes(ck, model, Y0, dt, stepper, 1 if run.mode & ck.MODE_IMPLICIT else steps)
    nz, ncol = next(iter(Y0["soil"].values())).shape
    ms = (k1 + k2) / 2
    read = sum(v.numel() for v in (forcing or {}).values()) + per_column_values(run, nz, ncol, dtype)
    b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, nz * ncol, steps, iters=getattr(stepper, "iters", 2),
                          ncol=ncol, probes=probes, read_values=read)
    err, plain_ms = checked
    if plain_at is None:
        plain_at = f"17a: nz=16 x {COLD_NCOL}, {IMPLICIT_STEPS if name.startswith('B4-') else cold_steps(dtype)} steps"
    most = f"; MOST probes per solve {probes:.4f}" if probes is not None else ""
    print(f"[{tag} time] {str(dtype)[6:]} {name} {steps} steps of dt={dt:g} nz={nz} ncol={ncol}: kernel "
          f"{k1:.3f}/{k2:.3f} ms ({nz * ncol * steps / (ms / 1e3):.4e} grid-points/s), plain {plain_ms:.3f} ms at "
          f"{plain_at}, bound {b_ms:.3f} ms by {b_by} ({b_ms / ms:.3f} of the kernel's time){most} on {smi}",
          flush=True)
    kernel, source = kernel_of(ck, run.mode, dtype)
    return {"name": f"{kernel}<{str(dtype)[6:].replace('float', 'f')}, {name}>", "route": "cuda", "source": source,
            "replaces": REPLACES, "launches": 1, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_at": plain_at, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _from_start_ms(run, Y0, t0, forcing=None, what=None):
    """Two samples (CUDA events) of one launch of ``run`` each from the
    start state ``Y0``, after an untimed one; the states must stay finite
    (checked where ``what`` names the run)."""
    states = [_clone(Y0) for _ in range(3)]
    run(states[0], t0, forcing=forcing)
    samples = tuple(_time_ms(lambda Yk=Yk: run(Yk, t0, forcing=forcing), 1) for Yk in states[1:])
    if what and not all(bool(torch.isfinite(v).all()) for Yk in states for f in Yk.values() for v in f.values()):
        raise AssertionError(f"{what}: the state left the finite numbers")
    return samples


def time_new_instances(ck, gc, costs, smi, dtype, device, checked, checked_rows, cold_probes_of):
    """17e: each new instance but the paths' at the width of its path: the
    water-only ones on 17c's storm, the implicit ones under 17d's cold MOST
    top (the plain soil's lagged no-ice ones on ``build_freeze_wide``'s
    column), ``IMPLICIT_DT``; then the 30 land policy instances with rows at
    16c's width, the rows carrying the model's own atmosphere and rain, so
    that the work (and the MOST probes, ``cold_probes_of[name]`` where 16c
    counted them, else counted here as 16c counts them) is 16c's.  The
    implicit MOST instances' probes are counted once per stepper, on its
    instance without a policy (as 21d counts them).
    ``checked`` and ``checked_rows`` are 17a's and 16a's ``(error, plain
    ms)`` of each.  Returns the kernel records."""
    from landhydrology_tpu_torch.timestepping import SSPRK33

    entries = []
    for name in WATER_MODES:
        if name not in STORM_PATHS:
            land, Y0 = build_storm(dtype, device, name)
            entries.append(time_at_width(ck, costs, smi, land, Y0, SSPRK33(), STORM_DT, STORM_T0, name,
                                         checked[name]))
    torch.cuda.empty_cache()
    probes_of = {}  # the MOST probes per solve of each stepper without a policy (as 21d counts them)
    for name in IMPLICIT_MODES:
        if name in COLD_IMPLICIT_PATHS:
            continue
        stepper, case = implicit_case(name)
        probes = None
        if case.startswith("B2+B6-pond"):
            soil, Y0, _, _ = build_freeze_wide(gc, dtype, device, None)
            soil = dataclasses.replace(soil, freeze_thaw=None, coefficient_update="step", assume_no_ice=True)
        else:
            soil, Y0, _, _ = build_cold_land(gc, dtype, device, case)
            if stepper not in probes_of:
                bare = build_cold_land(gc, dtype, device, "B5")[0]
                probes_of[stepper] = cold_probes(ck, bare, Y0, IMPLICIT_DT, implicit(stepper, bare, 2), 1)
            probes = probes_of[stepper]
        entries.append(time_at_width(ck, costs, smi, soil, Y0, implicit(stepper, soil, 2), IMPLICIT_DT, 0.0, name,
                                     checked[name], probes=probes))
    torch.cuda.empty_cache()
    for name in COLD_MODES:
        model, Y0, _, dt = build_cold_land(gc, dtype, device, name)
        soil = getattr(model, "soil", model)
        rows = {}
        if "-pond" not in name:
            rows["theta_atm"] = torch.full((COLD_TIMED_STEPS, NCOL), COLD_THETA_ATM, dtype=dtype, device=device)
        if soil is not model:
            rows["precipitation"] = torch.full((COLD_TIMED_STEPS, NCOL), 8e-6, dtype=dtype, device=device)
        entries.append(time_at_width(ck, costs, smi, model, Y0, SSPRK33(), dt, 0.0, f"{name}+B7", checked_rows[name],
                                     forcing=rows, probes=cold_probes_of.get(name)))
    torch.cuda.empty_cache()
    return entries


def cold_forced_phase(ck, costs, smi, device, t_start, cold_checked, cold_probes_of, after_checks=None):
    """Phase 17: 17a's checks (``cold_forced_checks``), 17b's cold forced
    reanalysis (``cold_forced_path``, its forcing written once to a
    temporary file), 17c's storm (``storm_path``), 17d's implicit paths
    (``cold_implicit_path``), 17e's times (``time_new_instances``), with
    16a's checks (``cold_checked``, ``{dtype: {name: (error, plain ms)}}``)
    and 16c's MOST probes (``cold_probes_of``, ``{(dtype, name): probes}``,
    empty where phase 16 did not run); ``after_checks`` (``main``: the
    run-file CLIs' checks, ``CliAhead.check``) runs once, after the first
    float type's 17a checks, and returns kernel records.  Returns ``(kernel
    records, 17d's paths for phase 6)``."""
    import tempfile

    from landhydrology_tpu_torch.runtime import write_forcing

    gc = _load_golden_config()
    entries, paths = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cold_forcing.bin")
        times, rows = reanalysis_forcing(COLD_FORCED_STEPS, FORCED_NCOL, FORCED_DT)
        rows["theta_atm"] = rows["theta_atm"] - np.float32(COLD_FORCED_SHIFT)
        write_forcing(path, times, rows)
        del rows
        for dtype in (torch.float64, torch.float32):
            tag = str(dtype)[6:]
            checked = cold_forced_checks(ck, dtype, device)
            _mark(t_start, f"phase 17a's {tag} checks")
            if after_checks is not None:
                entries += after_checks()
                after_checks = None
                _mark(t_start, "the run-file CLIs' checks (15b, 18b)")
            for setting in COLD_FORCED_PATHS:
                entries.append(cold_forced_path(ck, costs, smi, dtype, device, setting, path))
                torch.cuda.empty_cache()
            _mark(t_start, f"phase 17b's {tag} forced paths")
            for case in STORM_PATHS:
                entries.append(storm_path(ck, costs, smi, dtype, device, case))
                torch.cuda.empty_cache()
            _mark(t_start, f"phase 17c's {tag} storm")
            for name in COLD_IMPLICIT_PATHS:
                paths.append(cold_implicit_path(ck, gc, dtype, device, name))
                torch.cuda.empty_cache()
            _mark(t_start, f"phase 17d's {tag} implicit paths")
            probes = {name: p for (d, name), p in cold_probes_of.items() if d == dtype}
            entries += time_new_instances(ck, gc, costs, smi, dtype, device, checked, cold_checked[dtype], probes)
            _mark(t_start, f"phase 17e's {tag} times")
    return entries, paths


# ---- phase 18: the explicit steppers under a MOST top and a LandModel (ROADMAP B1 remainder), the implicit
# steppers' policies on the water-only branch (B4 remainder) ----

#: 18c: the 48 land instances without MODE_COLUMNS (csrc/land_kernel.cu, csrc/land_policy_kernel.cu): the ten
#: surface modes without a policy, the 30 policy ones, the 8 water-only LandModel ones
LAND_PLAIN_MODES = ("B5", "B2+B5", "B6", "B6-step", "B2+B6", "B2+B6-step", "B6-pond", "B6-step-pond", "B2+B6-pond",
                    "B2+B6-step-pond")
LAND_RK_MODES = LAND_PLAIN_MODES + COLD_MODES + WATER_MODES
#: 18d: the implicit steppers with the policies on the water-only branch (csrc/implicit_branch_kernel.cu), on
#: build_stiff's column (nz=16 x COLD_NCOL) over WATER_POLICY_STEPS steps of WATER_POLICY_DT (20x its explicit
#: limit), iters=2: Thomas, and PCR (a run-time flag) on two
WATER_POLICY_MODES = tuple(st + "-water" + p for st in ("B4-trbdf2", "B4-be-richards")
                           for p in ("+B2", "-no-ice", "-no-ice+B2"))
WATER_POLICY_PCR = ("B4-trbdf2-water+B2", "B4-be-richards-water-no-ice+B2")
WATER_POLICY_DT, WATER_POLICY_STEPS = 5.0, 2
#: 18c and 18d: each instance timed at width over launches of this many steps
RK_TIMED_STEPS = 2
#: 18b: bench.py::build_land's LandModel in the reference (B6) and production (B2+B6-step) settings,
#: (surface_update, coefficient_update), each written into a run file under SSPRK104 with hydrostatic initial
#: conditions and a pond; CLI_LAUNCHES launches of SPC steps; then these steppers timed at width under B6
LAND_CLI_SETTINGS = {"B6": ("stage", "stage"), "B2+B6-step": ("step", "step")}
LAND_CLI_IC = {"kind": "hydrostatic", "z_table": -1.0, "T": 288.0, "h_s0": 1e-4}
LAND_CLI_TIMED = ("ForwardEuler", "SSPRK22")
#: 18a: the lagged stiff path's step in units of dt_exp.  Lagging K across a TR-BDF2 step on the wetting front
#: leaves the physical range between 5 and 8 dt_exp, in the JAX package as in the port (at phase 8's 40 dt_exp
#: vartheta_l reaches -1.1 in 8 steps; tests/test_torch_stiff_lagged_divergence.py); at 4 dt_exp the lagged run
#: stays within 7.7e-3 of the stage run (9.3e-3 at 5), under bench.py's max_dev_lagged bar of 1e-2
STIFF_LAGGED_FACTOR = 4


def land_rk_cases():
    """18c's checks: ``(instance, stepper, rows)`` of each of
    ``LAND_RK_MODES``, the new steppers cycled over them (ForwardEuler ->
    SSPRK22 -> SSPRK104, the cycle shifted by one every three instances, so
    that a policy's place in its block of six does not fix its stepper),
    and step-indexed forcing rows on every third instance: each stepper
    meets lagged coefficients, rate and equilibrium freeze-thaw, no ice, the
    frozen exchange, MOST and plain tops and the water-only LandModel, with
    rows and without (``tests/test_torch_chip_smoke_land_rk.py``)."""
    return [(name, RK_STEPPERS[(i + i // 3) % 3], i % 3 == 0) for i, name in enumerate(LAND_RK_MODES)]


def land_rk_width(gc, dtype, device, name, base):
    """``(model, state, dt, t0)`` of an 18c instance at width: 16c's cold
    column at nz=64 x 65,536 (``build_cold_land`` on ``base``, as 16c times
    the SSPRK33 instances) or, for the water-only ones, 17c's storm
    (``build_storm``, as 17e times theirs); dt theirs, or half the explicit
    limit where that is less (``explicit_dt_limit`` assumes SSPRK33's
    extent: under 0.625 of ForwardEuler's)."""
    from landhydrology_tpu_torch.diagnostics import explicit_dt_limit

    if "-water" in name:
        (model, Y0), dt, t0 = build_storm(dtype, device, name), STORM_DT, STORM_T0
    else:
        (model, Y0, _, dt), t0 = build_cold_land(gc, dtype, device, name, base=base), 0.0
    limit = float(explicit_dt_limit(getattr(model, "soil", model), {"soil": Y0["soil"]}))
    return model, Y0, min(dt, 0.5 * limit), t0


def land_rk_checks(ck, costs, smi, dtype, device):
    """18c: each of ``land_rk_cases`` (``cold_check`` under its stepper,
    16a's steps from t0 = 5 s, 2 in f64 and 4 in f32, where the change bar
    needs the water of the no-ice MOST columns to move, on 16a's cold
    column, its water-only LandModel for the ``-water`` ones; the freeze
    bars with freeze-thaw), then timed at width (``land_rk_width``,
    ``time_at_width``: ``RK_TIMED_STEPS`` steps, with rows where the check
    has them, carrying the model's own atmosphere and rain as 17e's do; the
    bound's MOST probes from the plain version's ForwardEuler step on every
    ``COLD_PROBE_STRIDE``-th column).  Returns the kernel records."""
    gc = _load_golden_config()
    base = build_freeze_wide(gc, dtype, device, None)
    entries, lines = [], []
    for name, stepper, rows in land_rk_cases():
        err, shares, grown, melted, plain_ms, _ = cold_check(ck, name, dtype, device, rows=rows, tag="18c",
                                                             stepper=stepper)
        model, Y0, dt, t0 = land_rk_width(gc, dtype, device, name, base)
        soil = getattr(model, "soil", model)
        ncol = Y0["soil"]["vartheta_l"].shape[1]
        forcing = {} if rows else None
        if rows and "-pond" not in name:
            forcing["theta_atm"] = torch.full((RK_TIMED_STEPS, ncol), COLD_THETA_ATM, dtype=dtype, device=device)
        if rows and soil is not model:
            forcing["precipitation"] = torch.full((RK_TIMED_STEPS, ncol), 8e-6, dtype=dtype, device=device)
        probes = None
        if "-pond" not in name:
            probes = cold_probes(ck, model, Y0, dt, _stepper("ForwardEuler"), 1)
        run_name = f"{name}{'+B7' if rows else ''}@{stepper}"
        entries.append(time_at_width(ck, costs, smi, model, Y0, _stepper(stepper), dt, t0, run_name, (err, plain_ms),
                                     forcing, probes, RK_TIMED_STEPS, "18c",
                                     f"18c: nz=16 x {COLD_NCOL}, {cold_steps(dtype)} steps"))
        lines.append(f"{run_name} {err:.2e} ({_fmt(shares)}; ice grew in {grown}, melted in {melted})")
        del model, Y0, forcing
    del base
    torch.cuda.empty_cache()
    print(f"[18c land rk] {str(dtype)[6:]} {len(lines)} land instances under ForwardEuler, SSPRK22 and SSPRK104 on "
          f"{COLD_NCOL} columns at 268-278 K with 0.02 of ice (the water-only ones T 270-275 K prescribed, no ice), "
          f"{cold_steps(dtype)} steps of 2 s, a third with per-column forcing rows: kernel vs plain max abs (change error "
          f"/ largest change, bar {INCREMENT_RTOL[dtype]:g}; columns where theta_i changed): " + "; ".join(lines),
          flush=True)
    return entries


def water_policy_case(name, dtype, device, icy=False, base=None):
    """``(model, state, stepper)`` of an 18d instance: ``build_stiff``'s
    column (nz=16 x ``COLD_NCOL``, or ``base``: ``build_stiff``'s model and
    state at another size) with the policy of its name, its implicit
    stepper (iters=2, PCR where the name says so); ``icy``: the state of
    ``icy_state``."""
    pcr = "-pcr" in name
    name = name.replace("-pcr", "")
    model, Y = build_stiff(16, COLD_NCOL, dtype, device)[:2] if base is None else base
    model = dataclasses.replace(model, coefficient_update="step" if name.endswith("+B2") else "stage",
                                assume_no_ice="-no-ice" in name)
    if icy:
        Y = icy_state(model, Y)
    stepper = implicit("TRBDF2Soil" if name.startswith("B4-trbdf2") else "BackwardEulerRichards", model, 2,
                       "pcr" if pcr else "thomas")
    return model, Y, stepper


def water_policy_checks(ck, costs, smi, dtype, device):
    """18d: each of ``WATER_POLICY_MODES`` (and PCR on ``WATER_POLICY_PCR``)
    on ``build_stiff``'s column, ``WATER_POLICY_STEPS`` steps of
    ``WATER_POLICY_DT`` from t0 = 2 s, against the plain version
    (``check_variant``: ``_check``, ``_check_increment``), the no-ice ones
    also on the icy state, where no ice differs from the plain mode; each
    timed at 18a's width and step (``build_stiff`` at nz=64 x 65,536,
    ``STIFF_LAGGED_FACTOR`` dt_exp; ``time_at_width``, ``RK_TIMED_STEPS``
    steps).  Returns the kernel records."""
    entries, lines = [], []
    names = WATER_POLICY_MODES + tuple(n.replace("-water", "-water-pcr") if "no-ice" not in n
                                       else n.replace("-no-ice", "-no-ice-pcr") for n in WATER_POLICY_PCR)
    wide = build_stiff(NZ, NCOL, dtype, device)[:2]
    dt_wide = STIFF_LAGGED_FACTOR * stiff_dt_explicit(*wide)
    for name in names:
        for icy in (False, True) if "no-ice" in name else (False,):
            model, Y0, stepper = water_policy_case(name, dtype, device, icy)
            what = f"18d {'icy ' if icy else ''}{str(dtype)[6:]} {name}"
            plain, _, _, plain_ms = _counting_solves(lambda: ck.fused_column_run_plain(
                model, stepper, WATER_POLICY_DT, WATER_POLICY_STEPS, Y0, 2.0))
            kern, plain, shares = check_variant(ck, model, _clone(Y0), WATER_POLICY_DT, WATER_POLICY_STEPS, 2.0, what,
                                                ("vartheta_l",), stepper=stepper, plain=plain)
            built = ck.make_fused_column_run(model, stepper).name
            if built != name:
                raise AssertionError(f"{what}: mode {built}")
            err = _max_abs(kern, plain)
            lines.append(f"{name}{' icy' if icy else ''} {err:.2e} ({_fmt(shares)}, plain {plain_ms:.1f} ms)")
            if not icy:
                model, Y0, stepper = water_policy_case(name, dtype, device, base=wide)
                entries.append(time_at_width(ck, costs, smi, model, Y0, stepper, dt_wide, 0.0, name, (err, plain_ms),
                                             steps=RK_TIMED_STEPS, tag="18d",
                                             plain_at=f"18d: nz=16 x {COLD_NCOL}, {WATER_POLICY_STEPS} steps"))
    del wide
    torch.cuda.empty_cache()
    print(f"[18d water policies] {str(dtype)[6:]} the implicit steppers' policies on the water-only branch, "
          f"build_stiff's column on {COLD_NCOL} columns, {WATER_POLICY_STEPS} steps of {WATER_POLICY_DT:g} s, "
          "iters=2; the no-ice ones also on the icy state (theta_i 0.05, vartheta_l = nu - 0.02 in the lower half): "
          f"kernel vs plain max abs (change error / largest change, bar {INCREMENT_RTOL[dtype]:g}): "
          + "; ".join(lines), flush=True)
    return entries


def lagged_stiff_paths(ck, device):
    """18a: ``bench.py``'s stiff path (``build_stiff`` at nz=64 x 65,536)
    with lagged coefficients (``coefficient_update="step"``, as the
    production land setting lags K), ``TRBDF2Soil(iters=2)`` at
    ``STIFF_LAGGED_FACTOR`` dt_exp, 8 steps in one launch, f32 and f64,
    driven and checked as in phase 8 (``drive_path``); its largest deviation
    from the stage-coefficient run (a kernel launch, phase 8's instance)
    held to bench.py's max_dev_lagged bar of 1e-2.  Returns the paths for
    phase 6's times."""
    paths = []
    for dtype in (torch.float32, torch.float64):
        stage, Y0, Ya = build_stiff(NZ, NCOL, dtype, device)
        model = dataclasses.replace(stage, coefficient_update="step")
        dt_imp = STIFF_LAGGED_FACTOR * stiff_dt_explicit(model, Y0)
        st = implicit("TRBDF2Soil", model, 2)
        kern, launches, err, _ = drive_path(ck, model, Y0, Ya, dt_imp, STIFF_STEPS, STIFF_STEPS, "18a stiff lagged",
                                            ("vartheta_l",), stepper=st)
        ref = _clone(Y0)
        ck.make_fused_column_run(stage, implicit("TRBDF2Soil", stage, 2), dt=dt_imp, steps_per_call=STIFF_STEPS)(ref, 0.0)
        dev = float(np.max(np.abs(kern["vartheta_l"] - _np(ref)["vartheta_l"])))
        low = float(np.min(kern["vartheta_l"]))
        if not (dev < 1e-2 and low >= 0.0):
            raise AssertionError(f"18a {dtype}: the lagged run deviates {dev} from the stage run, min vartheta_l {low}")
        print(f"[18a stiff lagged] {str(dtype)[6:]} B4-trbdf2-water+B2 at {STIFF_LAGGED_FACTOR} dt_exp = {dt_imp!r} s: "
              f"max_dev_lagged (max |vartheta_l| deviation from the stage run, B4-trbdf2-water) {dev:.3e} (bench.py bar "
              f"1e-2), min vartheta_l {low:.4f}", flush=True)
        paths.append((model, Y0, dt_imp, STIFF_STEPS, launches, err, st))
        del stage, ref
        torch.cuda.empty_cache()
    return paths


def land_slice(model, Y, idx):
    """The sub-LandModel and state of the columns ``idx``
    (``column_slice`` of its soil, the pond sliced alike)."""
    sub, Ys = column_slice(model.soil, {"soil": Y["soil"]}, idx)
    Ys["surface"] = {"h_s": Y["surface"]["h_s"][idx].contiguous()}
    return dataclasses.replace(model, soil=sub), Ys


def short_check(ck, model, stepper, dt, Y0, what, moving):
    """18b's check of an instance: a launch of ``COLD_TIMED_STEPS`` steps
    of ``stepper`` from ``Y0`` at full width against the plain version's on
    every ``COLD_PROBE_STRIDE``-th column (``_check``, ``_check_increment``;
    the plain launch timed and its MOST probes counted).  Returns ``(max
    abs error, shares, probes, plain ms, plain_at)``."""
    dtype = model.soil.float_dtype
    few = torch.arange(0, NCOL, COLD_PROBE_STRIDE, device=Y0["soil"]["vartheta_l"].device)
    short = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=COLD_TIMED_STEPS)
    Ys = _clone(Y0)
    short(Ys, 0.0)
    got = {k: v[..., few.cpu().numpy()] for k, v in _np(Ys).items()}
    sub, Yp = land_slice(model, Y0, few)
    plain, _, probes, plain_ms = _counting_solves(lambda: ck.fused_column_run_plain(
        sub, stepper, dt, COLD_TIMED_STEPS, Yp, 0.0))
    plain = _np(plain)
    _check(got, plain, dtype, what)
    shares = _check_increment(got, plain, _np(Yp), dtype, what, moving)
    nz = Y0["soil"]["vartheta_l"].shape[0]
    return _max_abs(got, plain), shares, probes, plain_ms, f"18b: nz={nz} x {len(few)}, {COLD_TIMED_STEPS} steps"


def land_cli_files(device, workdir):
    """18b's run files in ``workdir``: ``bench.py::build_land``'s LandModel
    at nz=64 x 65,536 in each of ``LAND_CLI_SETTINGS``, written by
    ``config.to_config`` (hydrostatic initial conditions, a pond of 1e-4 m,
    SSPRK104, ``"engine": "pallas"``, f64; dt as 15b chooses it):
    ``CLI_LAUNCHES`` launches of ``SPC`` steps, saved at each.  Returns
    ``({setting: (run file, output)}, {setting: dt})``."""
    from landhydrology_tpu_torch import cli
    from landhydrology_tpu_torch.config import to_config
    from landhydrology_tpu_torch.diagnostics import explicit_dt_limit

    dts, files = {}, {}
    n_cli = CLI_LAUNCHES * SPC
    for setting, (surface, lagged) in LAND_CLI_SETTINGS.items():
        land, _, _ = build_land_model(NZ, NCOL, torch.float64, device, surface, lagged)
        path, out = os.path.join(workdir, f"land_{setting}.json"), os.path.join(workdir, f"land_{setting}.npz")
        cfg = {"model": to_config(land), "initial_conditions": dict(LAND_CLI_IC),
               "simulation": {"dt": 1.0, "t_final": 1.0, "stepper": "SSPRK104", "engine": "pallas",
                              "steps_per_call": SPC}}
        with open(path, "w") as f:
            json.dump(cfg, f)
        model, _, Y_ic, Ya, _, _ = cli.load_run(path, device)
        dt = dts[setting] = 2.0 ** math.floor(math.log2(0.5 * float(explicit_dt_limit(model.soil, Y_ic))))
        cfg["simulation"].update(dt=dt, t_final=n_cli * dt, saveat=SPC * dt)
        cfg["output"] = {"path": out}
        with open(path, "w") as f:
            json.dump(cfg, f)
        files[setting] = (path, out)
        del land, model, Y_ic, Ya
    return files, dts


def land_cli_check(ck, costs, smi, device, files, dts, runs):
    """18b's checks of the CLI runs ``runs`` (``CliRuns`` of
    ``land_cli_files``' files, together): a straight ``Simulation`` of
    each file's model and state in this process (launch counts set to 0
    just before and read just after) equals the CLI's saves bit for bit;
    the instance is held to the plain version by ``short_check`` (a launch
    of ``COLD_TIMED_STEPS`` steps: fewer plain launches, for the script's
    time) and timed at width (CUDA events, x3 twice).  Returns the kernel
    records."""
    from landhydrology_tpu_torch import Simulation, cli

    entries, n_cli = [], CLI_LAUNCHES * SPC
    moving = ("vartheta_l", "rho_e_int", "h_s")
    ran = dict(zip(files, runs.results()))
    for setting, (path, out) in files.items():
        model, _, Y_ic, Ya, _, _ = cli.load_run(path, device)
        dt, name = dts[setting], f"{setting}@SSPRK104"
        _, launches, wall = ran[setting]
        if launches != {name: CLI_LAUNCHES}:
            raise AssertionError(f"18b {setting}: the CLI's launches {launches}, expected {CLI_LAUNCHES} of {name}")
        sim = Simulation(model, _stepper("SSPRK104"), Y_init=Y_ic, Ya_init=Ya, dt=dt, tspan=(0.0, n_cli * dt),
                         saveat=SPC * dt, engine="fused", steps_per_call=SPC)
        torch.cuda.synchronize()
        ck.LAUNCHES.clear()
        clock = time.perf_counter()
        sol = sim.run()
        torch.cuda.synchronize()
        straight_ms = (time.perf_counter() - clock) * 1e3
        if dict(ck.LAUNCHES) != {name: CLI_LAUNCHES}:
            raise AssertionError(f"18b {setting} straight run: launches {dict(ck.LAUNCHES)}")
        saved = np.load(out)
        for group, fields in sol.us.items():
            for k, v in fields.items():
                key = k if group == "soil" else f"{group}/{k}"
                if not np.array_equal(saved[key], v.cpu().numpy()):
                    raise AssertionError(f"18b {setting}: the CLI's saves differ from the straight run in {key}")
        del sol, sim, saved
        err, shares, probes, plain_ms, plain_at = short_check(ck, model, _stepper("SSPRK104"), dt, Y_ic,
                                                              f"18b {name}", moving)
        run = ck.make_fused_column_run(model, _stepper("SSPRK104"), dt=dt, steps_per_call=SPC)
        Yk = _clone(Y_ic)
        run(Yk, 0.0)
        k1, k2 = (_time_ms(lambda: run(Yk, 0.0), 3) for _ in range(2))
        ms = (k1 + k2) / 2
        b_ms, b_by = bound_ms(ck, costs, run.mode, torch.float64, NZ * NCOL, SPC, ncol=NCOL, probes=probes)
        print(f"[18b land cli] f64 {name} nz={NZ} x {NCOL}, hydrostatic (z_table -1 m, 288 K), pond 1e-4 m, dt {dt!r} s "
              f"(under half of explicit_dt_limit): python -m landhydrology_tpu_torch run (beside the other setting's): "
              f"{CLI_LAUNCHES} launches of {SPC} steps, {wall:.6f} s host clock; the "
              f"straight Simulation {straight_ms:.3f} ms, its {CLI_LAUNCHES + 1} saves = the CLI's bit for bit; a "
              f"launch of {plain_at[5:]} vs plain max abs {err:.3e}, change error / largest change {_fmt(shares)} "
              f"(bar {INCREMENT_RTOL[torch.float64]:g}; plain {plain_ms:.1f} ms); kernel {k1:.3f}/{k2:.3f} ms per "
              f"launch ({NZ * NCOL * SPC / (ms / 1e3):.4e} grid-points/s), bound {b_ms:.3f} ms by {b_by}, MOST probes "
              f"per solve {probes:.4f} on {smi}", flush=True)
        kernel, source = kernel_of(ck, run.mode, torch.float64)
        entries.append({"name": f"{kernel}<f64, {name}>", "route": "cuda", "source": source, "replaces": REPLACES,
                        "launches": CLI_LAUNCHES, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "plain_at": plain_at, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        del model, Y_ic, Yk, run
        torch.cuda.empty_cache()
    return entries


def land_cli_times(ck, costs, smi, device, dts):
    """18b's times: one launch of ``SPC`` steps of B6 under each of
    ``LAND_CLI_TIMED`` at the run files' width and dt (``dts``), f32 and
    f64, and in f32 the two SSPRK104 instances, each timed at width and held
    by ``short_check`` (the record's plain time and the MOST probes of its
    bound).  Returns the kernel records."""
    from landhydrology_tpu_torch import cli

    entries = []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype)[6:]
        for setting, (surface, lagged) in LAND_CLI_SETTINGS.items():
            land, _, _ = build_land_model(NZ, NCOL, dtype, device, surface, lagged)
            Y0, _ = cli._build_ic(land, LAND_CLI_IC)
            steppers = (("SSPRK104",) if dtype == torch.float32 else ()) + (LAND_CLI_TIMED if setting == "B6" else ())
            dt = dts[setting]
            for stepper in steppers:
                st = _stepper(stepper)
                run = ck.make_fused_column_run(land, st, dt=dt, steps_per_call=SPC)
                Yk = _clone(Y0)
                torch.cuda.synchronize()
                ck.LAUNCHES.clear()
                run(Yk, 0.0)
                torch.cuda.synchronize()
                if dict(ck.LAUNCHES) != {run.name: 1}:
                    raise AssertionError(f"18b {run.name}: launches {dict(ck.LAUNCHES)}")
                k1, k2 = (_time_ms(lambda: run(Yk, 0.0), 3) for _ in range(2))
                if not all(bool(torch.isfinite(v).all()) for f in Yk.values() for v in f.values()):
                    raise AssertionError(f"18b {run.name}: the state left the finite numbers")
                err, _, probes, plain_ms, plain_at = short_check(ck, land, st, dt, Y0, f"18b {tag} {run.name}",
                                                                 ("vartheta_l", "h_s"))
                ms = (k1 + k2) / 2
                b_ms, b_by = bound_ms(ck, costs, run.mode, dtype, NZ * NCOL, SPC, ncol=NCOL, probes=probes)
                print(f"[18b time] {tag} {run.name} {SPC} steps of dt={dt:g} nz={NZ} ncol={NCOL}: kernel "
                      f"{k1:.3f}/{k2:.3f} ms ({NZ * NCOL * SPC / (ms / 1e3):.4e} grid-points/s), plain {plain_ms:.3f} "
                      f"ms ({plain_at}; one sample, max abs {err:.3e}), "
                      f"bound {b_ms:.3f} ms by {b_by} ({b_ms / ms:.3f} of the kernel's time), MOST probes per solve "
                      f"{probes:.4f} on {smi}", flush=True)
                kernel, source = kernel_of(ck, run.mode, dtype)
                entries.append({"name": f"{kernel}<{tag.replace('float', 'f')}, {run.name}>", "route": "cuda",
                                "source": source, "replaces": REPLACES, "launches": 1, "max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "plain_at": plain_at, "bound_ms": b_ms, "bound_by": b_by,
                                "library_ms": None})
                del run, Yk
            del land, Y0
            torch.cuda.empty_cache()
    return entries


def land_cli_phase(ck, costs, smi, device, workdir):
    """18b: ``land_cli_files``' run files run by ``python -m
    landhydrology_tpu_torch run`` in subprocesses, the two together
    (``CliRuns`` with ``together``), and checked (``land_cli_check``), then the other
    steppers timed (``land_cli_times``).  ``main`` runs the CLIs beside
    17a's checks instead (``CliAhead``).  Returns the kernel records."""
    files, dts = land_cli_files(device, workdir)
    runs = CliRuns([path for path, _ in files.values()], "18b", together=True)
    return land_cli_check(ck, costs, smi, device, files, dts, runs) + land_cli_times(ck, costs, smi, device, dts)


def land_rk_phase(ck, costs, smi, device, t_start, ahead=None):
    """Phase 18: 18a's lagged stiff paths (``lagged_stiff_paths``, timed in
    phase 6), 18b's LandModel run files (``land_cli_phase``, in a temporary
    directory removed at its end; with ``ahead``, a ``CliAhead``, their
    times alone, ``land_cli_times``: ``main`` runs and checks their CLIs
    beside 17a), 18c's land instances under the new steppers
    (``land_rk_checks``) and 18d's water-branch policies
    (``water_policy_checks``), f64 and f32.  Returns ``(kernel records,
    18a's paths)``."""
    import tempfile

    paths = lagged_stiff_paths(ck, device)
    _mark(t_start, "phase 18a")
    if ahead is not None:
        entries = land_cli_times(ck, costs, smi, device, ahead.land_dts)
    else:
        with tempfile.TemporaryDirectory() as workdir:
            entries = land_cli_phase(ck, costs, smi, device, workdir)
    _mark(t_start, "phase 18b")
    for dtype in (torch.float64, torch.float32):
        entries += land_rk_checks(ck, costs, smi, dtype, device)
        _mark(t_start, f"phase 18c's {str(dtype)[6:]} checks")
        entries += water_policy_checks(ck, costs, smi, dtype, device)
        _mark(t_start, f"phase 18d's {str(dtype)[6:]} checks")
        torch.cuda.empty_cache()
    return entries, paths


# ---- phase 19: per-column BC kinds and geometry in the land modes (ROADMAP B item 1: B1-batched and B8 under
# a MOST top and a LandModel, every explicit stepper, with forcing rows) ----

#: 19c: the steppers each family of land instances rotates through
COLUMNS_STEPPERS = ("ForwardEuler", "SSPRK22", "SSPRK33", "SSPRK104")
#: 19c: the seed of ``with_columns``'s kinds and depths
COLUMNS_SEED = 41
#: 19a: catchment.py's storm at its regolith depth (``build_storm(variable_depth=True)``), in the reference and
#: production settings of the water-only LandModel; 19b: its --atmos soil there, in the production setting (the
#: stage-table instance) and the reference one (land_kernel.cu's SSPRK33 instance with MODE_COLUMNS)
DEPTH_STORM_PATHS = ("B6-pond-water", "B2+B6-step-pond-water")
ATMOS_STORM_PATHS = ("B2+B6-step", "B6")
#: 19d: each instance timed at width over launches of this many steps
COLUMNS_TIMED_STEPS = 4


def with_columns(model, seed, kinds=True, depth=True):
    """19c and 19d: ``model`` (a land model, a MOST soil or a plain soil on
    a ``Column`` of a flat column batch) with per-column BC kinds (``BatchedBC``, kernel
    mode B1-batched) where ``kinds``: at the bottom the hydrology FLUX (-1e-7
    m/s), DIRICHLET (0.30) or FREE_DRAINAGE, the energy (a dynamic one) FLUX
    (0) or DIRICHLET (268-278 K), and under a plain top its energy FLUX or
    DIRICHLET likewise (the top faces the surface exchange supplies keep
    theirs); on the heat-only branch the energy kinds at both faces; and
    per-column depths (a ``VariableDepthColumn``, kernel mode B8) of 0.8-1.2
    times the column's own where ``depth``.  Drawn from
    ``default_rng(seed)``."""
    from landhydrology_tpu_torch import (
        BatchedBC, SoilColumnBC, SoilComponentBC, SoilEnergyModel, SoilHydrologyModel, VariableDepthColumn,
    )

    land = hasattr(model, "soil")
    soil = model.soil if land else model
    ncol, nz = soil.domain.batch_shape[0], soil.domain.nelements
    rng = np.random.default_rng(seed)
    tensor = lambda x: torch.as_tensor(x, dtype=soil.float_dtype, device=soil.device)  # noqa: E731
    codes = lambda n: torch.as_tensor(rng.integers(0, n, ncol), device=soil.device)  # noqa: E731

    def energy_kinds():
        kind = codes(2)
        return BatchedBC(kind=kind, value=torch.where(kind == 1, tensor(rng.uniform(268.0, 278.0, ncol)), tensor(0.0)))

    if kinds and not isinstance(soil.hydrology_model, SoilHydrologyModel):  # heat-only
        soil = dataclasses.replace(soil, boundary_conditions=SoilColumnBC(
            top=SoilComponentBC(energy=energy_kinds()), bottom=SoilComponentBC(energy=energy_kinds())))
    elif kinds:
        bcs = soil.boundary_conditions
        coupled = isinstance(soil.energy_model, SoilEnergyModel)
        kind = codes(3)
        water = BatchedBC(kind=kind, value=torch.where(kind == 1, tensor(0.30), tensor(-1e-7)))
        bottom = SoilComponentBC(hydrology=water, energy=energy_kinds() if coupled else bcs.bottom.energy)
        top = bcs.top
        if isinstance(top, SoilComponentBC) and coupled:
            top = dataclasses.replace(top, energy=energy_kinds())
        soil = dataclasses.replace(soil, boundary_conditions=SoilColumnBC(top=top, bottom=bottom))
    if depth:  # of the model's uniform Column
        z_bottom, z_top = soil.domain.zlim
        soil = dataclasses.replace(soil, domain=VariableDepthColumn(
            z_bottom=z_top - (z_top - z_bottom) * rng.uniform(0.8, 1.2, ncol), z_top=z_top, nelements=nz,
            batch_shape=(ncol,)))
    return dataclasses.replace(model, soil=soil) if land else soil


def land_columns_cases():
    """19c's checks: ``(instance, stepper, rows)`` of each of
    ``LAND_RK_MODES`` with per-column kinds and depths, the four explicit
    steppers of ``COLUMNS_STEPPERS`` cycled over them (the cycle shifted by
    one every four instances), and step-indexed forcing rows on every third:
    each family (the surface modes, each policy, the water-only LandModel)
    meets every stepper, and each stepper meets rows and none
    (``tests/test_torch_chip_smoke_land_columns.py``)."""
    return [(name, COLUMNS_STEPPERS[(i + i // 4) % 4], i % 3 == 0) for i, name in enumerate(LAND_RK_MODES)]


def land_columns_checks(ck, costs, smi, dtype, device):
    """19c and 19d: each of ``land_columns_cases`` (``cold_check`` with
    ``columns``: 16a's steps from t0 = 5 s, 2 in f64 and 4 in f32, on 16a's
    cold column or its water-only LandModel with ``with_columns``'s kinds
    and depths; the freeze bars with freeze-thaw), then timed at width
    (``land_rk_width``'s model with the same kinds and depths drawn for its
    columns, dt at most half its explicit limit; ``time_at_width``:
    ``COLUMNS_TIMED_STEPS`` steps, rows where the check has them, carrying
    the model's own atmosphere and rain; the bound's MOST probes from the
    plain version's ForwardEuler step on every ``COLD_PROBE_STRIDE``-th
    column, its reads the per-column grid and kinds too).  Returns the
    kernel records."""
    from landhydrology_tpu_torch.diagnostics import explicit_dt_limit

    gc = _load_golden_config()
    base = build_freeze_wide(gc, dtype, device, None)
    entries, lines = [], []
    for name, stepper, rows in land_columns_cases():
        err, shares, grown, melted, plain_ms, _ = cold_check(ck, name, dtype, device, rows=rows, tag="19c",
                                                             stepper=stepper, columns=True)
        model, Y0, dt, t0 = land_rk_width(gc, dtype, device, name, base)
        model = with_columns(model, COLUMNS_SEED)
        soil = getattr(model, "soil", model)
        dt = min(dt, 0.5 * float(explicit_dt_limit(soil, {"soil": Y0["soil"]})))
        ncol = Y0["soil"]["vartheta_l"].shape[1]
        forcing = {} if rows else None
        if rows and "-pond" not in name:
            forcing["theta_atm"] = torch.full((COLUMNS_TIMED_STEPS, ncol), COLD_THETA_ATM, dtype=dtype, device=device)
        if rows and soil is not model:
            forcing["precipitation"] = torch.full((COLUMNS_TIMED_STEPS, ncol), 8e-6, dtype=dtype, device=device)
        probes = None
        if "-pond" not in name:
            probes = cold_probes(ck, model, Y0, dt, _stepper("ForwardEuler"), 1)
        run_name = f"{name}+kinds+B8{'+B7' if rows else ''}" + ("" if stepper == "SSPRK33" else f"@{stepper}")
        entries.append(time_at_width(ck, costs, smi, model, Y0, _stepper(stepper), dt, t0, run_name, (err, plain_ms),
                                     forcing, probes, COLUMNS_TIMED_STEPS, "19d",
                                     f"19c: nz=16 x {COLD_NCOL}, {cold_steps(dtype)} steps"))
        lines.append(f"{run_name} {err:.2e} ({_fmt(shares)}; ice grew in {grown}, melted in {melted})")
        del model, Y0, forcing
    del base
    torch.cuda.empty_cache()
    print(f"[19c land columns] {str(dtype)[6:]} {len(lines)} land instances with per-column BC kinds (bottom "
          f"hydrology flux / Dirichlet / free drainage, energy flux / Dirichlet, and so a plain top's energy) and "
          f"depths (0.8-1.2 of 2 m) under ForwardEuler, SSPRK22, SSPRK33 and SSPRK104 on {COLD_NCOL} columns at "
          f"268-278 K with 0.02 of ice (the water-only ones T 270-275 K prescribed, no ice), {cold_steps(dtype)} "
          f"steps of 2 s, a third with per-column forcing rows: kernel vs plain max abs (change error / largest "
          f"change, bar {INCREMENT_RTOL[dtype]:g}; columns where theta_i changed): " + "; ".join(lines), flush=True)
    return entries


def land_columns_phase(ck, costs, smi, device, t_start):
    """Phase 19: 19a catchment.py's storm at its regolith depth
    (``storm_path`` with ``variable_depth``: ``DEPTH_STORM_PATHS``, the water
    budget with each column's dz), 19b its ``--atmos`` soil there
    (``ATMOS_STORM_PATHS``), 19c and 19d the 48 land instances with
    per-column kinds and depths (``land_columns_checks``), f64 and f32.
    Returns the kernel records."""
    entries = []
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype)[6:]
        for case in DEPTH_STORM_PATHS:
            entries.append(storm_path(ck, costs, smi, dtype, device, case, variable_depth=True, tag="19a"))
            torch.cuda.empty_cache()
        for case in ATMOS_STORM_PATHS:
            entries.append(storm_path(ck, costs, smi, dtype, device, case, variable_depth=True, atmos=True, tag="19b"))
            torch.cuda.empty_cache()
        _mark(t_start, f"phase 19a-b's {tag} storms")
        entries += land_columns_checks(ck, costs, smi, dtype, device)
        _mark(t_start, f"phase 19c-d's {tag} instances")
    return entries


# ---- phase 20: per-column BC kinds and geometry in the plain-soil modes, every stepper and step policy ----

#: 20c: the 16 plain-soil modes with MODE_COLUMNS under the explicit steppers (``csrc/rk_columns_kernel.cu``; B1
#: and B1-no-ice the column-tile kernel's, ``TILE_SOIL_MODES``), in families (coupled, water-only, heat-only) whose
#: order gives each member its stepper in ``soil_columns_cases``' rotation (B2, B3-rate and B1-water never SSPRK33,
#: whose MODE_COLUMNS instance of theirs is ``column_kernel.cu``'s, phase 12's)
SOIL_RK_MODES = ("B1", "B2", "B1-no-ice", "B2-no-ice", "B3-rate", "B2+B3-rate", "B3-eq", "B2+B3-eq",
                 "B2-water", "B1-water", "B1-water-no-ice", "B2-water-no-ice",
                 "B1-heat", "B2-heat", "B1-heat-no-ice", "B2-heat-no-ice")
#: 20c: the 28 implicit instances of ``csrc/implicit_columns_kernel.cu``: BackwardEulerSoil, each stepper with
#: each policy, and the water-only branch's policies
SOIL_IMPLICIT_MODES = (("B4-be-soil",) + tuple(st + p for st in IMPLICIT_STEPPERS for p in IMPLICIT_POLICIES)
                       + tuple(st + "-water" + p for st in ("B4-trbdf2", "B4-be-richards")
                               for p in ("+B2", "-no-ice", "-no-ice+B2")))
#: 20c: the implicit instances also checked with PCR solves (read at run time)
SOIL_IMPLICIT_PCR = ("B4-trbdf2+B2+B3-rate", "B4-be-richards-water+B2")
#: 20c: the columns of a check, the implicit steppers' dt and steps, and the explicit steppers' steps per float
#: type (the implicit ones take 2 in f32 too, as 17a's: over 4 f32 steps of 30 s the icy state's Dirichlet
#: bottom cells cross the saturation branch of psi in one version and not in the other)
SOIL_COLUMNS_NCOL, SOIL_IMPLICIT_DT, SOIL_IMPLICIT_STEPS = 1000, 30.0, 2
SOIL_COLUMNS_STEPS = {torch.float64: 2, torch.float32: 4}
#: the modes of the column-tile kernel (``csrc/tile_columns_kernel.cu``) under every explicit stepper
TILE_SOIL_MODES = ("B1", "B1-no-ice")
#: 20e: the column-tile kernel's checks at an odd depth and at the verify recipe's nz=150, (nz, ncol) each with a
#: ragged last tile under both float types' plans, under these steppers
TILE_SHAPES, TILE_STEPPERS = ((7, 1001), (150, 333)), ("SSPRK33", "SSPRK104")
#: 20b: the run file's launches of GRID_SPC steps of GRID_DT, its constant start, the strided plain check
SOIL_CLI_LAUNCHES, SOIL_CLI_VARTHETA, SOIL_CLI_STRIDE = 2, 0.2, 64


def columns_checks(ck, dtype, cases, build, t0, ncol, tag, about):
    """20c's and 21c's checks: each of ``cases`` built by ``build(case)`` as
    ``(model, state, stepper, dt, steps, run name, the run's source,
    forcing rows or None)`` on ``ncol`` columns, a launch of ``steps`` steps
    from ``t0`` against the plain version's (``check_diverged``: the same
    columns, at most 1% (or 2), out of ``_physical_columns``' range in both,
    where a cold start's Dirichlet faces take an implicit step past its two
    Newton sweeps; on the others the freeze bars of ``_check_freeze`` after
    the launch's projections with freeze-thaw, else ``_check``, and
    ``_check_increment`` with ``carried_allowance``, in f32 with the
    equilibrium projection on ``unpartitioned``'s quantities), the plain
    launch timed (host clock, synchronized); the run must come from its
    source and launch once, a freeze-thaw one grow ice in some columns and
    melt it in others.  Prints one line, ``[tag] <float type> <count>
    checks of <about>``, with each case's seconds.  Returns ``[(*case, run
    name, error, plain ms)]``."""
    out, lines = [], []
    for case in cases:
        clock_case = time.perf_counter()
        model, Y, stepper, dt, steps, name, source, forcing = build(case)
        what = f"{tag.split()[0]} {str(dtype)[6:]} {name}"
        start = _np(Y)
        torch.cuda.synchronize()
        clock = time.perf_counter()
        plain = ck.fused_column_run_plain(model, stepper, dt, steps, Y, t0, forcing=forcing)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - clock) * 1e3
        freeze = model.freeze_thaw is not None
        check = (lambda a, b, d, w, m=model: _check_freeze(a, b, m, d, w, steps)) if freeze else _check
        moving, change_of = tuple(k for k in ("vartheta_l", "rho_e_int") if k in start), None
        if dtype == torch.float32 and _projection_allowance(model, dtype)[0]:
            # the f32 projection's partition spread does not shrink with the change (phase 5's f32 B3-eq): the
            # change bar holds the total water and rho_e_int, which no projection moves, _check_freeze the state
            change_of, moving = unpartitioned(model), ("water", "rho_e_int")
        run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=steps,
                                       forcing_fields=tuple(forcing or ()))
        built = ck._entry(run.mode, dtype)[0]
        if run.name != name or built != source:
            raise AssertionError(f"{what}: built {run.name} from {built}")
        torch.cuda.synchronize()
        ck.LAUNCHES.clear()
        run(Y, t0, forcing=forcing)
        torch.cuda.synchronize()
        if dict(ck.LAUNCHES) != {name: 1}:
            raise AssertionError(f"{what}: launches {dict(ck.LAUNCHES)}, expected one of {name}")
        kern, plain = _np(Y), _np(plain)
        shares, err, diverged = check_diverged(kern, plain, start, dtype, what, moving, sound=_physical_columns,
                                               check=check, extra=carried_allowance(model, dtype, steps),
                                               change_of=change_of)
        if diverged > max(2, ncol // 100):
            raise AssertionError(f"{what}: {diverged} columns left the range in both versions")
        ice = ""
        if freeze:
            grown, melted = _ice_columns(kern, start)
            if not (grown and melted):
                raise AssertionError(f"{what}: ice grew in {grown} columns and melted in {melted}")
            ice = f"; ice grew in {grown}, melted in {melted} columns"
        del kern, plain, Y, model
        out.append((*case, name, err, plain_ms))
        div = f", {diverged} columns out of the range in both" if diverged else ""
        lines.append(f"{name} {err:.2e} ({_fmt(shares)}, plain {plain_ms:.1f} ms{ice}{div}; "
                     f"{time.perf_counter() - clock_case:.1f} s)")
    torch.cuda.empty_cache()
    print(f"[{tag}] {str(dtype)[6:]} {len(lines)} checks of {about}: kernel vs plain max abs (change error / largest "
          f"change, bar {INCREMENT_RTOL[dtype]:g}): " + "; ".join(lines), flush=True)
    return out


def columns_times(ck, costs, smi, checked, build, tag):
    """20d's and 21d's times: each of ``checked`` (``columns_checks``) but
    the PCR repeats (a PCR repeat's instance is timed with Thomas solves),
    built at width by ``build(case)`` as ``(model, start state, stepper, dt,
    t0, forcing rows or None, MOST probes or None, where its check ran)``
    and timed by ``time_at_width`` from the start state over
    ``COLUMNS_TIMED_STEPS`` steps, its record carrying the check's error and
    plain ms.  Returns the kernel records."""
    entries = []
    for *case, name, err, plain_ms in checked:
        if "pcr" in case:
            continue
        model, Y0, stepper, dt, t0, forcing, probes, plain_at = build(tuple(case))
        entries.append(time_at_width(ck, costs, smi, model, Y0, stepper, dt, t0, name, (err, plain_ms), forcing,
                                     probes, steps=COLUMNS_TIMED_STEPS, tag=tag, plain_at=plain_at,
                                     from_start=True))
        del model, Y0, forcing
    torch.cuda.empty_cache()
    return entries


@dataclasses.dataclass(frozen=True)
class RunFile:
    """A run file that ``run_file_cli`` drives: its path (the output beside
    it, ``.npz``), its instance and source, its launches of ``spc`` steps of
    ``dt``, the stride of the plain check, the phase's tag, what the printed
    line calls it, the plain version's stepper for a slice of the file's
    model and stepper (``plain_stepper(sub, stepper)``), and whether the
    bound counts MOST probes."""
    path: str
    name: str
    source: str
    launches: int
    spc: int
    dt: float
    stride: int
    tag: str
    about: str
    plain_stepper: object = None
    most: bool = False


def run_file_cli(ck, costs, smi, device, spec, started):
    """20b and 21b: the CLI run ``started`` (``_start_cli`` of ``spec.path``,
    a ``RunFile``) collected: it launched ``spec.name`` ``spec.launches``
    times; its first save equals bit for bit a launch of the file's model
    and state in this process (launch counts set to 0 just before and read
    just after, from ``spec.source``), that launch on every
    ``spec.stride``-th column meets the plain version (``check_diverged``),
    then the launch is timed (CUDA events, two samples) beside its bound.
    Returns its kernel record."""
    from landhydrology_tpu_torch import cli

    tag = spec.tag
    _, launches, wall = _finish_cli(started, f"{tag} run file")
    if launches != {spec.name: spec.launches}:
        raise AssertionError(f"{tag}: launches {launches}, expected {spec.launches} of {spec.name}")
    saved = np.load(os.path.splitext(spec.path)[0] + ".npz")
    run_model, st, Y_ic, _, _, _ = cli.load_run(spec.path, device)
    run = ck.make_fused_column_run(run_model, st, dt=spec.dt, steps_per_call=spec.spc)
    if run.name != spec.name or ck._entry(run.mode, torch.float64)[0] != spec.source:
        raise AssertionError(f"{tag}: the file's run is {run.name} from {ck._entry(run.mode, torch.float64)[0]}")
    Yk = _clone(Y_ic)
    torch.cuda.synchronize()
    ck.LAUNCHES.clear()
    run(Yk, 0.0)
    torch.cuda.synchronize()
    if dict(ck.LAUNCHES) != {spec.name: 1}:
        raise AssertionError(f"{tag}: the file's first launch counted {dict(ck.LAUNCHES)}")
    first = _np(Yk)
    if not all(np.array_equal(saved[k][1], first[k], equal_nan=True) for k in first):
        raise AssertionError(f"{tag}: the CLI's first save differs from the file's first launch in this process")
    nz, ncol = next(iter(first.values())).shape
    idx = torch.arange(0, ncol, spec.stride, device=device)
    sub, Y_sub = column_slice(run_model, Y_ic, idx)
    stp = st if spec.plain_stepper is None else spec.plain_stepper(sub, st)
    start = _np(Y_sub)
    torch.cuda.synchronize()
    clock = time.perf_counter()
    Yp = ck.fused_column_run_plain(sub, stp, spec.dt, spec.spc, Y_sub, 0.0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - clock) * 1e3
    cols = idx.cpu().numpy()
    kern = {k: v[:, cols] for k, v in first.items()}
    shares, err, div = check_diverged(kern, _np(Yp), start, torch.float64, f"{tag} first launch vs plain",
                                      ("vartheta_l", "rho_e_int"))
    end = {k: saved[k][-1] for k in first}
    lost = int((~_sound_columns(end)).sum())
    k1, k2 = (_time_ms(lambda: run(Yk, 0.0), 1) for _ in range(2))
    probes = most_probes(ck, sub, stp, spec.dt, 1, Y_sub)[1] if spec.most else None  # the solves of one step
    b_ms, b_by = bound_ms(ck, costs, run.mode, torch.float64, nz * ncol, spec.spc, ncol=ncol, probes=probes,
                          read_values=per_column_values(run, nz, ncol, torch.float64))
    ms, n = (k1 + k2) / 2, spec.launches * spec.spc
    most = f"; MOST probes per solve {probes:.4f}" if probes is not None else ""
    print(f"[{tag} cli] {spec.about}: python -m landhydrology_tpu_torch run: kernel launches {launches}, "
          f"{nz * ncol * n / wall:.4e} grid-points/s end to end ({wall:.3f} s host clock); its first save equal bit "
          f"for bit to the file's first launch here; every {spec.stride}th column ({len(cols)}) of it vs plain max abs "
          f"{err:.3e}, change error / largest change {_fmt(shares)} ({div} columns diverged in both); {lost} of {ncol} "
          f"columns out of the range after {n} steps; kernel {k1:.3f}/{k2:.3f} ms per launch of {spec.spc} steps, "
          f"plain {plain_ms:.3f} ms on the strided columns, bound {b_ms:.3f} ms by {b_by} ({b_ms / ms:.3f} of the "
          f"kernel's time{most}) on {smi}", flush=True)
    kernel, source = kernel_of(ck, run.mode, torch.float64)
    return {"name": f"{kernel}<f64, {spec.name}>", "route": "cuda", "source": source, "replaces": REPLACES,
            "launches": spec.launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "plain_at": f"{tag}: every {spec.stride}th column, {spec.spc} steps", "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def soil_columns_cases():
    """20c's checks: ``(mode, stepper, tridiag)`` of every new instance:
    ``SOIL_RK_MODES`` under ``COLUMNS_STEPPERS`` cycled (shifted by one every
    four modes, as ``land_columns_cases``: each family meets every stepper),
    ``SOIL_IMPLICIT_MODES`` under their own stepper with Thomas solves, and
    ``SOIL_IMPLICIT_PCR`` with PCR."""
    cases = [(name, COLUMNS_STEPPERS[(i + i // 4) % 4], None) for i, name in enumerate(SOIL_RK_MODES)]
    cases += [(name, None, "thomas") for name in SOIL_IMPLICIT_MODES]
    return cases + [(name, None, "pcr") for name in SOIL_IMPLICIT_PCR]


def pcr_name(name):
    """A run name with ``-pcr`` where ``mode_name`` puts it: after the
    stepper, branch and ``-no-ice``, before the policies' ``+``."""
    head, plus, tail = name.partition("+")
    return f"{head}-pcr{plus}{tail}"


def soil_columns_variant(ncol, dtype, device, seed, mode, stepper_name, tridiag, nz=16, cold=True):
    """``(model, state, stepper, dt, run name)`` of one of
    ``soil_columns_cases`` on ``build_grid_variant``'s column (kinds at both
    faces, depths 0.8-3.0 m, with ``cold`` the cold start of the freeze and
    no-ice modes, the explicit no-ice ones on its icy state): an explicit
    mode under ``stepper_name`` at the variant's dt, an implicit one at
    ``SOIL_IMPLICIT_DT`` with ``tridiag``.  The implicit no-ice modes skip the
    icy cells: there one-ulp changes of the start state move the plain
    version's rho_e_int by up to 1e-11 of itself after 2 steps of 30 s
    (BackwardEulerSoil lagged), past the f64 bar of 1e-12; the CPU tests hold
    their cap on an icy state against the JAX package's kernel."""
    model, Y, stepper, dt, _ = build_grid_variant(ncol, dtype, device, seed, mode, nz=nz, cold=cold,
                                                  icy=tridiag is None)
    if tridiag is None:
        stepper = _stepper(stepper_name)
        name = mode + "+kinds+B8" + ("" if stepper_name == "SSPRK33" else f"@{stepper_name}")
    else:
        stepper = implicit(IMPLICIT_STEPPERS[next(s for s in IMPLICIT_STEPPERS if mode.startswith(s))], model, 2,
                           tridiag)
        dt = SOIL_IMPLICIT_DT
        name = (pcr_name(mode) if tridiag == "pcr" else mode) + "+kinds+B8"
    return model, Y, stepper, dt, name


def soil_columns_checks(ck, dtype, device):
    """20c: each of ``soil_columns_cases`` (``soil_columns_variant``) on
    ``SOIL_COLUMNS_NCOL`` columns, ``SOIL_COLUMNS_STEPS`` steps from t0 = 2 s
    (``SOIL_IMPLICIT_STEPS`` of 30 s under the implicit steppers), from
    ``rk_columns_kernel``, ``tile_columns_kernel`` (``TILE_SOIL_MODES``) or
    ``implicit_columns_kernel`` (``columns_checks``).  Returns ``[(mode,
    stepper name, tridiag, run name, error, plain ms)]`` for
    ``soil_columns_times``."""

    def build(case):
        mode, stepper_name, tridiag = case
        model, Y, stepper, dt, name = soil_columns_variant(SOIL_COLUMNS_NCOL, dtype, device, 7, mode, stepper_name,
                                                           tridiag)
        steps = SOIL_IMPLICIT_STEPS if tridiag else SOIL_COLUMNS_STEPS[dtype]
        source = ("implicit_columns_kernel" if tridiag else "tile_columns_kernel" if mode in TILE_SOIL_MODES
                  else "rk_columns_kernel")
        return model, Y, stepper, dt, steps, name, source, None

    return columns_checks(
        ck, dtype, soil_columns_cases(), build, 2.0, SOIL_COLUMNS_NCOL, "20c soil columns",
        f"the 44 plain-soil instances with per-column BC kinds (hydrology and energy at both faces) and depths "
        f"(0.8-3.0 m) on {SOIL_COLUMNS_NCOL} columns, {SOIL_COLUMNS_STEPS[dtype]} steps under the explicit steppers "
        f"(rotated), {SOIL_IMPLICIT_STEPS} of {SOIL_IMPLICIT_DT:g} s under the implicit ones (iters=2, two also with "
        f"PCR), the freeze-thaw and no-ice modes from 268-278 K with 0.02 of ice (the explicit no-ice ones on its icy "
        f"state)")


def tile_shape_checks(ck, dtype, device):
    """20e: the column-tile kernel's modes (``TILE_SOIL_MODES``) under
    ``TILE_STEPPERS`` at each of ``TILE_SHAPES`` (``soil_columns_variant``'s
    kinds and depths, the no-ice modes on the icy state, the variant's dt
    scaled by min(1, (16 / nz)^2) with the spacing), ``SOIL_COLUMNS_STEPS``
    steps from t0 = 2 s against the plain version (``columns_checks``)."""
    for nz, ncol in TILE_SHAPES:
        plan = ck.tile_plan(nz, torch.finfo(dtype).bits // 8, 3)

        def build(case, nz=nz, ncol=ncol):
            mode, stepper_name = case
            model, Y, stepper, dt, name = soil_columns_variant(ncol, dtype, device, 7, mode, stepper_name, None,
                                                               nz=nz)
            return (model, Y, stepper, dt * min(1.0, (16 / nz) ** 2), SOIL_COLUMNS_STEPS[dtype], name,
                    "tile_columns_kernel", None)

        columns_checks(ck, dtype, [(m, s) for m in TILE_SOIL_MODES for s in TILE_STEPPERS], build, 2.0, ncol,
                       "20e tile shapes", f"the column-tile kernel at nz={nz} x {ncol} (tiles of {plan.columns} "
                       f"columns x {plan.lanes} lanes, the last one ragged: {ncol % plan.columns} columns), "
                       f"{SOIL_COLUMNS_STEPS[dtype]} steps")


def soil_columns_times(ck, costs, smi, dtype, device, checked):
    """20d: each instance of 20c's ``checked`` (``soil_columns_checks``)
    timed at phase 12's variant width (``GRID_TIMED_NZ`` x
    ``GRID_TIMED_NCOL``, the same kinds and depths drawn for its columns,
    phase 12's warm start, dt scaled by (16 / ``GRID_TIMED_NZ``)^2 with the
    levels' spacing; ``columns_times``).  Returns the kernel records."""

    def build(case):
        mode, stepper_name, tridiag = case
        # from phase 12's warm start, at a dt scaled with the levels' spacing: the explicit limit scales with dz^2,
        # and from the cold start at nz=48 a few columns of 32,768 leave the finite numbers in the plain version
        # too (f32 under the implicit steppers, even at 30 s / 9)
        model, Y0, stepper, dt, _ = soil_columns_variant(GRID_TIMED_NCOL, dtype, device, 12, mode, stepper_name,
                                                         tridiag, nz=GRID_TIMED_NZ, cold=False)
        steps = SOIL_IMPLICIT_STEPS if tridiag else SOIL_COLUMNS_STEPS[dtype]
        return (model, Y0, stepper, dt * (16 / GRID_TIMED_NZ) ** 2, 2.0, None, None,
                f"20c: nz=16 x {SOIL_COLUMNS_NCOL}, {steps} steps")

    return columns_times(ck, costs, smi, checked, build, "20d")


def regional_run_file(device, workdir):
    """20b's run file in ``workdir`` (``regional_cli``): the variable-depth
    twin lagged, its constant start, SSPRK104 on the fused engine; returns
    its path."""
    from landhydrology_tpu_torch.config import to_config

    model, _, _, _ = build_regional(GRID_NZ, GRID_NCOL, torch.float64, device, variable_depth=True)
    model = dataclasses.replace(model, coefficient_update="step")
    path, out = os.path.join(workdir, "regional.json"), os.path.join(workdir, "regional.npz")
    n = SOIL_CLI_LAUNCHES * GRID_SPC
    cfg = {"model": to_config(model),
           "simulation": {"dt": GRID_DT, "t_final": n * GRID_DT, "saveat": GRID_SPC * GRID_DT, "stepper": "SSPRK104",
                          "engine": "pallas", "steps_per_call": GRID_SPC},
           "initial_conditions": {"kind": "constant", "vartheta_l": SOIL_CLI_VARTHETA, "T": 288.0},
           "output": {"path": out}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def regional_cli(ck, costs, smi, device, workdir, started=None):
    """20b: ``regional_grid.py``'s variable-depth twin (nz=48 x 131,072, f64)
    with lagged coefficients, written by ``to_config`` into a run file
    (``regional_run_file``: a constant start of vartheta_l
    ``SOIL_CLI_VARTHETA`` at 288 K, SSPRK104, ``"engine": "pallas"``,
    ``SOIL_CLI_LAUNCHES`` launches of ``GRID_SPC`` steps of ``GRID_DT``,
    saved at each) and run by ``python -m landhydrology_tpu_torch run`` in a
    subprocess (``B2+kinds+B8@SSPRK104``), held by ``run_file_cli`` on every
    ``SOIL_CLI_STRIDE``-th column.  ``started``: the CLI's subprocess of the
    file in ``workdir``, started beside other work (``_start_cli``); else it
    is run here.  Returns its kernel record."""
    path = os.path.join(workdir, "regional.json")
    if started is None:
        started = _start_cli(regional_run_file(device, workdir))
    spec = RunFile(path, "B2+kinds+B8@SSPRK104", "rk_columns_kernel", SOIL_CLI_LAUNCHES, GRID_SPC, GRID_DT,
                   SOIL_CLI_STRIDE, "20b", f"regional_grid.py's variable-depth twin, lagged, as a run file (SSPRK104, "
                   f"engine pallas, constant start {SOIL_CLI_VARTHETA} at 288 K)")
    return run_file_cli(ck, costs, smi, device, spec, started)


def soil_columns_phase(ck, costs, smi, device, t_start):
    """Phase 20: 20a the regional hour with ``assume_no_ice`` (``regional_path``
    with ``no_ice``: ``B1-no-ice+kinds`` and its variable-depth twin
    ``B1-no-ice+kinds+B8``, f32 and f64), whose diverged columns must be
    those phase 12's SSPRK33 B1 run leaves (``REGIONAL_DIVERGED``; run here
    when phase 12 did not), then timed as phase 6 times its paths; 20b the
    SSPRK104 run file (``regional_cli``), its CLI run started before 20c's
    checks of the 44 new instances (``soil_columns_checks``, f64 and f32),
    which run while it starts up, and 20e's checks of the column-tile kernel
    at odd and deep columns (``tile_shape_checks``); then 20d's times
    (``soil_columns_times``).  Returns the kernel records."""
    import tempfile

    paths, failures = [], []
    for dtype in (torch.float32, torch.float64):
        for variable_depth in (False, True):
            try:  # every path runs, so one run shows each path's failure
                if (dtype, variable_depth, False) not in REGIONAL_DIVERGED:
                    regional_path(ck, costs, smi, dtype, device, variable_depth, tag="20a B1")
                paths.append(regional_path(ck, costs, smi, dtype, device, variable_depth, no_ice=True, tag="20a"))
                b1, no_ice = (REGIONAL_DIVERGED[(dtype, variable_depth, x)] for x in (False, True))
                print(f"[20a] {str(dtype)[6:]} diverged columns with no ice {no_ice.size}, B1's {b1.size}: "
                      f"{'the same' if np.array_equal(b1, no_ice) else 'NOT the same'}", flush=True)
                if not np.array_equal(b1, no_ice):
                    raise AssertionError(f"20a {dtype} {variable_depth}: no ice diverges in {no_ice.tolist()[:20]}, "
                                         f"B1 in {b1.tolist()[:20]}")
            except AssertionError as e:
                print(f"[20a] FAILED: {e}", flush=True)
                failures.append(str(e))
            torch.cuda.empty_cache()
    entries = time_paths(ck, costs, smi, paths)
    del paths
    _mark(t_start, "phase 20a")
    with tempfile.TemporaryDirectory() as workdir:
        # 20b's CLI starts up in its subprocess while 20c's checks run (20d's times come after it)
        started = _start_cli(regional_run_file(device, workdir))
        checked = {}
        for dtype in (torch.float64, torch.float32):
            checked[dtype] = soil_columns_checks(ck, dtype, device)
            _mark(t_start, f"phase 20c's {str(dtype)[6:]} checks")
            tile_shape_checks(ck, dtype, device)
            _mark(t_start, f"phase 20e's {str(dtype)[6:]} checks")
        entries.append(regional_cli(ck, costs, smi, device, workdir, started))
    torch.cuda.empty_cache()
    _mark(t_start, "phase 20b")
    for dtype in (torch.float64, torch.float32):
        entries += soil_columns_times(ck, costs, smi, dtype, device, checked[dtype])
        _mark(t_start, f"phase 20d's {str(dtype)[6:]} times")
    if failures:
        raise AssertionError("phase 20a failed: " + " | ".join(failures))
    return entries


# ---- phase 21: per-column BC kinds and geometry under the implicit steppers with a MOST top (ROADMAP B item 2,
# MOST remainder: B1-batched and B8 under TR-BDF2, BackwardEulerSoil and BackwardEulerRichards, each policy) ----

#: 21c: the 24 instances of csrc/implicit_most_columns_kernel.cu: each implicit stepper under the MOST top without
#: a step policy and with each of IMPLICIT_POLICIES
MOST_COLUMNS_MODES = tuple(st + p + "+B5" for st in IMPLICIT_STEPPERS for p in ("",) + IMPLICIT_POLICIES)
#: 21c: the instances also checked with PCR solves (read at run time)
MOST_COLUMNS_PCR = ("B4-trbdf2+B2+B3-rate+B5", "B4-be-richards-no-ice+B5")
#: 21a: 17d's two paths with per-column kinds and depths, the first with step-indexed theta_atm rows (+B7)
MOST_COLUMNS_PATHS = ("B4-trbdf2+B3-rate+B5", "B4-trbdf2+B2+B3-eq+B5")
MOST_COLUMNS_ROWS_PATH = "B4-trbdf2+B3-rate+B5"
#: 21b: the flagship run file's soil (landhydrology_tpu/cli.py:406-423) alone, on a 1-D batch of
#: regional_grid.py's column count with depths 0.8-1.2 of 2 m and a BatchedBC hydrology bottom: launches of
#: FLAGSHIP_SPC steps of FLAGSHIP_DT under TRBDF2Soil (iters 2), the plain check on every FLAGSHIP_STRIDE-th column
FLAGSHIP_NZ, FLAGSHIP_NCOL, FLAGSHIP_DT, FLAGSHIP_SPC, FLAGSHIP_LAUNCHES, FLAGSHIP_STRIDE = 24, 131072, 60.0, 8, 2, 64
#: 21c's icy checks: the implicit no-ice instances with MODE_COLUMNS (implicit_columns_kernel.cu's and this
#: source's) on the icy state, f64, one step of ICY_COLUMNS_DT: over it a one-ulp change of the start state moves the
#: plain version by at most 6e-15 of itself (2 steps of 30 s: up to 4.7e-12 under BackwardEulerSoil lagged, past the
#: bar of 1e-12), held under ICY_ULP_BAR here before the kernel is held to it
ICY_COLUMNS_MODES = tuple(st + p for st in IMPLICIT_STEPPERS for p in ("-no-ice", "-no-ice+B2"))
ICY_COLUMNS_DT, ICY_ULP_BAR = 5.0, 1e-13


def most_columns_cases():
    """21c's checks: ``(mode, tridiag, rows)`` of each of
    ``MOST_COLUMNS_MODES`` with Thomas solves, step-indexed forcing rows on
    every third, then ``MOST_COLUMNS_PCR`` with PCR solves."""
    cases = [(mode, "thomas", i % 3 == 0) for i, mode in enumerate(MOST_COLUMNS_MODES)]
    return cases + [(mode, "pcr", False) for mode in MOST_COLUMNS_PCR]


def most_columns_variant(ncol, dtype, device, mode, tridiag="thomas", icy=False):
    """``(model, state, stepper, dt, steps)`` of a 21c check of ``mode`` (a
    name of ``MOST_COLUMNS_MODES``): ``policy_variant``'s cold MOST column
    (17a's: ``IMPLICIT_STEPS`` steps of ``IMPLICIT_DT``) on ``ncol`` columns
    with ``with_columns``' kinds at its bottom faces and depths, the stepper
    with ``tridiag`` solves; with ``icy`` on its ``icy_state``."""
    stepper, _ = implicit_case(mode)
    soil, Y, _, dt, steps = policy_variant(mode, dtype, device)
    if ncol != COLD_NCOL:
        soil, Y = column_slice(soil, Y, torch.arange(ncol, device=Y["soil"]["vartheta_l"].device))
    soil = with_columns(soil, COLUMNS_SEED)
    if icy:
        Y = icy_state(soil, Y)
    return soil, Y, implicit(stepper, soil, 2, tridiag), dt, steps


def most_columns_checks(ck, dtype, device):
    """21c: each of ``most_columns_cases`` on ``COLD_NCOL`` columns
    (``most_columns_variant``, rows from ``policy_rows`` where the case has
    them), from t0 = 5 s, from ``implicit_most_columns_kernel``
    (``columns_checks``).  Returns ``[(mode, tridiag, rows, run name, error,
    plain ms)]`` for ``most_columns_times``."""

    def build(case):
        mode, tridiag, rows = case
        model, Y, stepper, dt, steps = most_columns_variant(COLD_NCOL, dtype, device, mode, tridiag)
        name = (pcr_name(mode) if tridiag == "pcr" else mode) + "+kinds+B8" + ("+B7" if rows else "")
        forcing = policy_rows(model, steps, seed=37) if rows else None
        return model, Y, stepper, dt, steps, name, "implicit_most_columns_kernel", forcing

    return columns_checks(
        ck, dtype, most_columns_cases(), build, 5.0, COLD_NCOL, "21c most columns",
        f"the 24 implicit instances under the cold MOST top with per-column BC kinds (bottom hydrology flux / "
        f"Dirichlet / free drainage, energy flux / Dirichlet) and depths (0.8-1.2 of 2 m) on {COLD_NCOL} columns at "
        f"268-278 K with 0.02 of ice, {IMPLICIT_STEPS} steps of {IMPLICIT_DT:g} s (iters=2, two also with PCR), a "
        f"third with per-column theta_atm rows")


def most_columns_times(ck, costs, smi, dtype, device, checked):
    """21d: each instance of 21c's ``checked`` (``most_columns_checks``)
    timed at 17e's width (``build_cold_land``'s soil at nz=64 x 65,536 with
    ``with_columns``' kinds and depths drawn for its columns,
    ``IMPLICIT_DT``, rows of ``COLD_THETA_ATM`` where the check has rows;
    ``columns_times``).  The bound's MOST probes per solve are counted once
    per stepper (``cold_probes``: the plain version's step on every
    ``COLD_PROBE_STRIDE``-th column of the same start state, under the
    stepper without a policy): on this start state the 24 instances' own
    counts differ from their stepper's by under 0.1% (101.73-101.76 per
    solve in f64 on an H100).  Returns the kernel records."""
    gc = _load_golden_config()
    base = build_freeze_wide(gc, dtype, device, None)
    probes_of = {}

    def build(case):
        mode, _, rows = case
        stepper_name, name = implicit_case(mode)
        soil, Y0, _, _ = build_cold_land(gc, dtype, device, name, base=base)
        soil = with_columns(soil, COLUMNS_SEED)
        if stepper_name not in probes_of:
            bare = with_columns(build_cold_land(gc, dtype, device, "B5", base=base)[0], COLUMNS_SEED)
            probes_of[stepper_name] = cold_probes(ck, bare, Y0, IMPLICIT_DT, implicit(stepper_name, bare, 2), 1)
        forcing = None
        if rows:
            forcing = {"theta_atm": torch.full((COLUMNS_TIMED_STEPS, NCOL), COLD_THETA_ATM, dtype=dtype, device=device)}
        return (soil, Y0, implicit(stepper_name, soil, 2), IMPLICIT_DT, 0.0, forcing, probes_of[stepper_name],
                f"21c: nz=16 x {COLD_NCOL}, {IMPLICIT_STEPS} steps")

    return columns_times(ck, costs, smi, checked, build, "21d")


def _nudged(Y):
    """``Y`` with every value moved one ulp up."""
    return {g: {k: torch.nextafter(v, torch.full_like(v, float("inf"))) for k, v in f.items()} for g, f in Y.items()}


def icy_columns_checks(ck, device):
    """21c's icy checks: the six implicit no-ice instances with
    ``MODE_COLUMNS`` on the plain soil (``build_grid_variant``'s cold column
    with kinds at both faces and depths 0.8-3.0 m, on its ``icy_state``;
    ``implicit_columns_kernel.cu``) and their six twins under the MOST top
    (``most_columns_variant`` with ``icy``), f64, one step of
    ``ICY_COLUMNS_DT`` from t0 = 2 s: the plain version from the start state
    moved by one ulp must stay within ``ICY_ULP_BAR`` of itself (the step is
    well conditioned), the kernel within ``_check``'s 1e-12 of it
    (``check_diverged``), and the start state must hold cells with
    vartheta_l past nu - theta_i, where the rhs's cap (``MODE_RHS_CAP``)
    acts.  Returns ``{run name: (error, plain ms)}``."""
    dtype, out, lines = torch.float64, {}, []
    for most in (False, True):
        for mode in ICY_COLUMNS_MODES:
            if most:
                model, Y, stepper, _, _ = most_columns_variant(COLD_NCOL, dtype, device, mode + "+B5", icy=True)
                name = mode + "+B5+kinds+B8"
            else:
                model, Y, _, _, _ = build_grid_variant(SOIL_COLUMNS_NCOL, dtype, device, 7, mode, cold=True, icy=True)
                stepper = implicit(implicit_case(mode + "+B5")[0], model, 2)
                name = mode + "+kinds+B8"
            what = f"21c icy f64 {name}"
            nu = torch.as_tensor(model.soil_param_set.nu, dtype=dtype, device=device)
            if not bool((Y["soil"]["vartheta_l"] > nu - Y["soil"]["theta_i"]).any()):
                raise AssertionError(f"{what}: no cell of the start state has vartheta_l past nu - theta_i")
            start = _np(Y)
            torch.cuda.synchronize()
            clock = time.perf_counter()
            plain = _np(ck.fused_column_run_plain(model, stepper, ICY_COLUMNS_DT, 1, Y, 2.0))
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - clock) * 1e3
            moved = _np(ck.fused_column_run_plain(model, stepper, ICY_COLUMNS_DT, 1, _nudged(Y), 2.0))
            ok = _physical_columns(plain) & _physical_columns(moved)
            with np.errstate(invalid="ignore", divide="ignore"):
                ulp = max(float(np.max(np.abs(plain[k][:, ok] - moved[k][:, ok])
                                       / np.maximum(np.abs(plain[k][:, ok]), np.finfo(np.float64).tiny)))
                          for k in plain)
            if not ulp < ICY_ULP_BAR:
                raise AssertionError(f"{what}: a one-ulp change of the start state moves the plain version by {ulp:.2e} "
                                     f"of itself (bar {ICY_ULP_BAR:g}): the step is not well conditioned")
            run = ck.make_fused_column_run(model, stepper, dt=ICY_COLUMNS_DT, steps_per_call=1)
            source = ck._entry(run.mode, dtype)[0]
            if run.name != name or source != ("implicit_most_columns_kernel" if most else "implicit_columns_kernel"):
                raise AssertionError(f"{what}: built {run.name} from {source}")
            torch.cuda.synchronize()
            ck.LAUNCHES.clear()
            run(Y, 2.0)
            torch.cuda.synchronize()
            if dict(ck.LAUNCHES) != {name: 1}:
                raise AssertionError(f"{what}: launches {dict(ck.LAUNCHES)}, expected one of {name}")
            shares, err, diverged = check_diverged(_np(Y), plain, start, dtype, what, ("vartheta_l", "rho_e_int"),
                                                   sound=_physical_columns)
            out[name] = (err, plain_ms)
            lines.append(f"{name} {err:.2e} ({_fmt(shares)}; one ulp of the start moves the plain version {ulp:.1e}"
                         + (f"; {diverged} columns out of the range in both" if diverged else "") + ")")
            del model, Y
    print(f"[21c icy] f64 the 12 implicit no-ice instances with per-column kinds and depths on the icy state "
          f"(theta_i 0.05, vartheta_l = nu - 0.02 in the lower half), one step of {ICY_COLUMNS_DT:g} s from t0 = 2 s "
          f"(iters=2): kernel vs plain max abs (change error / largest change, bar {INCREMENT_RTOL[dtype]:g}): "
          + "; ".join(lines), flush=True)
    return out


def most_columns_path(ck, costs, smi, dtype, device, name):
    """21a: 17d's cold MOST column at width (``build_cold_land``'s soil,
    nz=64 x 65,536) with ``with_columns``' kinds at its bottom faces and
    depths 0.8-1.2 of 2 m, one launch of ``COLD_IMPLICIT_STEPS`` steps of
    ``IMPLICIT_DT`` in instance ``name`` + ``+kinds+B8``: through
    ``Simulation(engine="fused")`` (``drive_path``), or for
    ``MOST_COLUMNS_ROWS_PATH`` with step-indexed per-column theta_atm rows
    (``COLD_THETA_ATM`` +- 4 K) through ``make_forced_segment_run(engine=
    "fused")`` (``+B7``); the run equal bit for bit to the script's own
    launch of ``make_fused_column_run``, held to the plain version by a
    launch of ``IMPLICIT_STEPS`` steps from the start state (the freeze bars
    after as many projections, the change bar; in f32 an equilibrium path's
    on ``unpartitioned``'s quantities); ice must form.
    Then the launch timed from the start state (``time_at_width`` with
    ``from_start``: from the third launch on, a few of these columns leave
    the finite numbers in both versions), beside 17d's instance on the same
    start state and rows without the kinds and depths, timed alike: the
    cost of ``MODE_COLUMNS`` under MOST.  Returns the kernel record."""
    from landhydrology_tpu_torch.runtime import make_forced_segment_run

    stepper_name, case = implicit_case(name)
    gc = _load_golden_config()
    uniform, Y0, Ya, _ = build_cold_land(gc, dtype, device, case)
    soil = with_columns(uniform, COLUMNS_SEED)
    st = implicit(stepper_name, soil, 2)
    n, tag = COLD_IMPLICIT_STEPS, str(dtype)[6:]
    change_of, moving = None, ("vartheta_l", "rho_e_int")
    if dtype == torch.float32 and _projection_allowance(soil, dtype)[0]:
        change_of, moving = unpartitioned(soil), ("water", "rho_e_int")  # as 17d
    # held by a launch of IMPLICIT_STEPS from the start state, as 17d's f64 paths, in f32 too (a cut of plain
    # launches: 17d's f32 change errors over the whole launch sat at 5e-4 to 2e-3 of the change, the bar 0.1)
    steps = IMPLICIT_STEPS
    what = f"21a most columns {tag} {name}+kinds+B8"
    rows = None
    if name == MOST_COLUMNS_ROWS_PATH:
        rng = np.random.default_rng(COLUMNS_SEED)
        rows = {"theta_atm": torch.as_tensor(COLD_THETA_ATM + rng.uniform(-4.0, 4.0, (n, NCOL)), dtype=dtype,
                                             device=device)}
    fields = tuple(rows or ())
    run = ck.make_fused_column_run(soil, st, dt=IMPLICIT_DT, steps_per_call=n, forcing_fields=fields)
    if rows is None:
        kern, _, err, wall = drive_path(ck, soil, Y0, Ya, IMPLICIT_DT, n, n, what, moving, stepper=st,
                                        projections=n, change_of=change_of, plain_steps=steps)
        plain_ms = sum(_PATH_PLAIN_MS[_path_key(soil, Y0, IMPLICIT_DT, n, st)])
        Yl = _clone(Y0)
        run(Yl, 0.0)
    else:
        segment = make_forced_segment_run(soil, st, IMPLICIT_DT, fields, engine="fused", steps_per_call=n)
        torch.cuda.synchronize()
        ck.LAUNCHES.clear()
        clock = time.perf_counter()
        Yk, _ = segment({"soil": Y0["soil"]}, Ya, 0.0, rows)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - clock) * 1e3
        if dict(ck.LAUNCHES) != {run.name: 1}:
            raise AssertionError(f"{what}: launches {dict(ck.LAUNCHES)}, expected one of {run.name}")
        kern = _np(Yk)
        if not all(np.isfinite(v).all() for v in kern.values()):
            raise AssertionError(f"{what}: the forced run left the finite numbers")
        Yl = _clone(Y0)
        run(Yl, 0.0, forcing=rows)
        part = {k: v[:steps] for k, v in rows.items()}
        Ys = _clone(Y0)  # a launch of the checked steps from the start state
        ck.make_fused_column_run(soil, st, dt=IMPLICIT_DT, steps_per_call=steps, forcing_fields=fields)(
            Ys, 0.0, forcing=part)
        torch.cuda.synchronize()
        clock = time.perf_counter()
        plain = _np(ck.fused_column_run_plain(soil, st, IMPLICIT_DT, steps, Y0, 0.0, forcing=part))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - clock) * 1e3
        held, same = _np(Ys), change_of or (lambda Y: Y)
        water, energy = _check_freeze(held, plain, soil, dtype, what, steps)
        shares = _check_increment(same(held), same(plain), same(_np(Y0)), dtype, what, moving,
                                  carried_allowance(soil, dtype, steps))
        err = _max_abs(held, plain)
        print(f"[21a most columns] {tag} {run.name} make_forced_segment_run(engine='fused') "
              f"{tuple(kern['theta_i'].shape)} {n} steps: 1 launch, finite, kernel vs plain max abs {err:.3e} (held "
              f"by a launch of {steps} steps); change error / largest change {_fmt(shares)} (bar "
              f"{INCREMENT_RTOL[dtype]:g}) (freeze bars: partition +{water:.3e}, rho_e_int +{energy:.3e}); wall "
              f"{wall:.3f} ms", flush=True)
    loop = _np(Yl)
    if not all(np.array_equal(kern[k], loop[k], equal_nan=True) for k in kern):
        raise AssertionError(f"{what}: the run differs from the script's own launch")
    ice = float(np.max(kern["theta_i"]))
    if not ice > 1e-4:
        raise AssertionError(f"{what}: no ice formed (max theta_i {ice})")
    print(f"[21a most columns] {tag} {run.name} nz={NZ} x {NCOL}, {n} steps of dt={IMPLICIT_DT:g}, theta_atm "
          f"{COLD_THETA_ATM} K: equal bit for bit to the script's own launch; max theta_i {ice:.4e} (> 1e-4: ice "
          f"formed) in {int((kern['theta_i'].max(0) > 1e-6).sum())} columns; run {wall:.3f} ms", flush=True)
    del kern, loop, Yl
    record = time_at_width(ck, costs, smi, soil, Y0, st, IMPLICIT_DT, 0.0, run.name, (err, plain_ms), rows, steps=n,
                           tag="21a", plain_at=f"21a: nz={NZ} x {NCOL}, {steps} steps", from_start=True)
    twin = ck.make_fused_column_run(uniform, implicit(stepper_name, uniform, 2), dt=IMPLICIT_DT, steps_per_call=n,
                                    forcing_fields=fields)
    twin_ms = _from_start_ms(twin, Y0, 0.0, rows)
    print(f"[21a cost] {tag} {run.name} {record['ms']:.3f} ms per launch of {n} steps from the start state, 17d's "
          f"{twin.name} on the same state{' and rows' if rows else ''} {'/'.join(f'{m:.3f}' for m in twin_ms)} ms: "
          f"MODE_COLUMNS under MOST costs {record['ms'] / (sum(twin_ms) / 2):.4f}x on {smi}", flush=True)
    return record


def flagship_soil(device, ncol=None):
    """21b: the flagship run file's soil (``landhydrology_tpu/cli.py:406-423``:
    vanGenuchten n 2.0, alpha 2.6, Ksat 3e-7, nu 0.4, a MOST top at 297 K)
    on a 1-D batch of ``FLAGSHIP_NCOL`` columns (or ``ncol``) at nz=24, each
    column's depth 0.8-1.2 of its 2 m and a ``BatchedBC`` hydrology bottom of
    FLUX (-1e-7 m/s), DIRICHLET (0.30) or FREE_DRAINAGE, drawn from
    ``default_rng(COLUMNS_SEED)``; f64."""
    from landhydrology_tpu_torch import (
        BatchedBC, PrescribedAtmosForcing, SoilColumnBC, SoilComponentBC, SoilEnergyModel, SoilHydrologyModel,
        SoilModel, SoilParams, VariableDepthColumn, VerticalFlux,
    )
    from landhydrology_tpu_torch.models.soil import vanGenuchten

    ncol = FLAGSHIP_NCOL if ncol is None else ncol
    rng = np.random.default_rng(COLUMNS_SEED)
    kind = torch.as_tensor(rng.integers(0, 3, ncol), dtype=torch.int32, device=device)
    value = torch.where(kind == 1, torch.tensor(0.30, dtype=torch.float64, device=device),
                        torch.tensor(-1e-7, dtype=torch.float64, device=device))
    return SoilModel(
        domain=VariableDepthColumn(z_bottom=-2.0 * rng.uniform(0.8, 1.2, ncol), nelements=FLAGSHIP_NZ,
                                   batch_shape=(ncol,)),
        energy_model=SoilEnergyModel(),
        hydrology_model=SoilHydrologyModel(hydraulic_model=vanGenuchten(n=2.0, alpha=2.6, Ksat=3e-7, theta_r=0.05)),
        boundary_conditions=SoilColumnBC(
            top=PrescribedAtmosForcing(u_atm=2.0, theta_atm=297.0, z_atm=2.0, theta_scale=297.0, rho_a_sfc=1.2,
                                       q_atm=0.005),
            bottom=SoilComponentBC(hydrology=BatchedBC(kind=kind, value=value), energy=VerticalFlux(0.0))),
        soil_param_set=SoilParams(nu=0.4, S_s=1e-3, rho_c_ds=1.3e6),
        dtype=torch.float64, device=device)


def flagship_run_file(device, workdir):
    """21b's run file in ``workdir`` (``flagship_cli``): ``flagship_soil``,
    the flagship's constant start, TRBDF2Soil on the fused engine; returns
    its path."""
    from landhydrology_tpu_torch.config import to_config

    path, out = os.path.join(workdir, "flagship_soil.json"), os.path.join(workdir, "flagship_soil.npz")
    n = FLAGSHIP_LAUNCHES * FLAGSHIP_SPC
    cfg = {"model": to_config(flagship_soil(device)),
           "simulation": {"dt": FLAGSHIP_DT, "t_final": n * FLAGSHIP_DT, "saveat": FLAGSHIP_SPC * FLAGSHIP_DT,
                          "stepper": "TRBDF2Soil", "iters": 2, "engine": "pallas", "steps_per_call": FLAGSHIP_SPC},
           "initial_conditions": {"kind": "constant", "vartheta_l": 0.18, "T": 291.0},
           "output": {"path": out}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def flagship_cli(ck, costs, smi, device, workdir, started=None):
    """21b: ``flagship_soil`` written by ``to_config`` into a run file
    (``flagship_run_file``: a constant start of vartheta_l 0.18 at 291 K,
    the flagship's; TRBDF2Soil with ``"iters": 2``, ``"engine": "pallas"``,
    ``FLAGSHIP_LAUNCHES`` launches of ``FLAGSHIP_SPC`` steps of
    ``FLAGSHIP_DT``, saved at each) and run by ``python -m
    landhydrology_tpu_torch run`` in a subprocess
    (``B4-trbdf2+B5+kinds+B8``; ``started``: that subprocess started beside
    other work, ``_start_cli``, else run here), held by ``run_file_cli`` on
    every ``FLAGSHIP_STRIDE``-th column, its bound with the MOST probes of
    the plain version's step.  Returns its kernel record."""
    path = os.path.join(workdir, "flagship_soil.json")
    if started is None:
        started = _start_cli(flagship_run_file(device, workdir))
    spec = RunFile(path, "B4-trbdf2+B5+kinds+B8", "implicit_most_columns_kernel", FLAGSHIP_LAUNCHES, FLAGSHIP_SPC,
                   FLAGSHIP_DT, FLAGSHIP_STRIDE, "21b", f"the flagship run file's soil on a variable-depth regolith "
                   f"with a batched bottom (TRBDF2Soil, iters 2, engine pallas, constant start 0.18 at 291 K, dt "
                   f"{FLAGSHIP_DT:g} s)", plain_stepper=lambda sub, st: implicit("TRBDF2Soil", sub, 2), most=True)
    return run_file_cli(ck, costs, smi, device, spec, started)


def most_columns_phase(ck, costs, smi, device, t_start):
    """Phase 21: 21a 17d's cold MOST column with per-column kinds and depths
    (``most_columns_path``: ``MOST_COLUMNS_PATHS``, f64 and f32); 21b the
    flagship run file's soil through the CLI (``flagship_cli``), its run
    started before 21c's checks, which run while it starts up: the 12
    implicit no-ice instances with ``MODE_COLUMNS`` on the icy state
    (``icy_columns_checks``) and the 24 new instances (``most_columns_checks``,
    f64 and f32); then 21d's times (``most_columns_times``).  Returns the
    kernel records."""
    import tempfile

    entries = []
    for dtype in (torch.float64, torch.float32):
        for name in MOST_COLUMNS_PATHS:
            entries.append(most_columns_path(ck, costs, smi, dtype, device, name))
            torch.cuda.empty_cache()
    _mark(t_start, "phase 21a")
    with tempfile.TemporaryDirectory() as workdir:
        started = _start_cli(flagship_run_file(device, workdir))
        icy_columns_checks(ck, device)
        torch.cuda.empty_cache()
        _mark(t_start, "phase 21c's icy checks")
        checked = {}
        for dtype in (torch.float64, torch.float32):
            checked[dtype] = most_columns_checks(ck, dtype, device)
            _mark(t_start, f"phase 21c's {str(dtype)[6:]} checks")
        entries.append(flagship_cli(ck, costs, smi, device, workdir, started))
    torch.cuda.empty_cache()
    _mark(t_start, "phase 21b")
    for dtype in (torch.float64, torch.float32):
        entries += most_columns_times(ck, costs, smi, dtype, device, checked[dtype])
        _mark(t_start, f"phase 21d's {str(dtype)[6:]} times")
    return entries


def _fmt_ms(values):
    return "/".join(f"{v:.3f}" for v in values) + " ms"


def _fmt_rates(points, walls_ms):
    return "/".join(f"{points / (w / 1e3):.4e}" for w in walls_ms)


#: phase 3: the steps of the plain launch that holds a golden's kernel run (64 steps; golden #6's 16 a quarter of
#: it), a cut of plain launches for the script's time: the whole run stays held to the golden at rtol 1e-12
GOLDEN_PLAIN_STEPS = 16


def golden_phase(ck, gc, device):
    """Phase 3: the goldens in f64 through the kernels, the JAX fused tests'
    implicit cases and the 1,000-column variants (the module docstring's
    list)."""
    from landhydrology_tpu_torch import VerticalFlux
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw

    data = os.path.join(HERE, "tests", "data")
    golden = {name: np.load(os.path.join(data, f"golden_{name}_f64.npz"))
              for name in ("coupled", "lagged", "freeze", "implicit")}
    for kw, ref in (({}, "coupled"), ({"assume_no_ice": True}, "coupled"),
                    ({"coefficient_update": "step"}, "lagged"),
                    ({"coefficient_update": "step", "assume_no_ice": True}, "lagged")):
        model, Y, _, dt = gc.build_model_and_state(torch.float64, device)
        check_golden(ck, dataclasses.replace(model, **kw), Y, dt, gc.N_STEPS, golden[ref],
                     f"golden #1 vs golden_{ref}_f64.npz", plain_steps=GOLDEN_PLAIN_STEPS)
    model, Y, _, dt = gc.build_freeze_model_and_state(torch.float64, device)
    kern = check_golden(ck, model, Y, dt, gc.FREEZE_STEPS, golden["freeze"],
                        "freeze golden vs golden_freeze_f64.npz", plain_steps=GOLDEN_PLAIN_STEPS)
    if not float(np.max(kern["theta_i"])) > 1e-4:
        raise AssertionError("freeze golden: no ice formed in the kernel run")
    for freeze, lagged in ((EquilibriumFreezeThaw(), "stage"), (FreezeThaw(tau=60.0), "step"),
                           (EquilibriumFreezeThaw(), "step")):
        model, Y, _, dt = gc.build_freeze_model_and_state(torch.float64, device, freeze_thaw=freeze)
        check_golden(ck, dataclasses.replace(model, coefficient_update=lagged), Y, dt,
                     gc.FREEZE_STEPS, None, f"freeze golden's column, {type(freeze).__name__}")
    # golden #6: golden #1 under TR-BDF2 at dt=120 (test_golden_trajectories.py)
    for tridiag, atol in (("thomas", None), ("pcr", 1e-9)):
        model, Y, _, _ = gc.build_model_and_state(torch.float64, device)
        check_golden(ck, model, Y, 120.0, gc.N_STEPS // 4, golden["implicit"],
                     f"golden #1 under TRBDF2Soil(iters=3, {tridiag!r}) vs golden_implicit_f64.npz",
                     stepper=implicit("TRBDF2Soil", model, 3, tridiag), atol=atol,
                     plain_steps=GOLDEN_PLAIN_STEPS // 4)
    for name in ("BackwardEulerSoil", "BackwardEulerRichards"):
        model, Y, _, _ = gc.build_model_and_state(torch.float64, device)
        check_golden(ck, model, Y, 120.0, gc.N_STEPS // 4, None, f"golden #1 under {name}(iters=2)",
                     stepper=implicit(name, model, 2))
    # the JAX package's fused implicit tests (tests/test_pallas_kernel.py:395-555)
    small = dict(nz=16, ncol=256, dtype=torch.float64, device=device)
    model, Y = build_kernel_test_model(VerticalFlux(0.0), VerticalFlux(0.0), **small)
    check_golden(ck, model, Y, 600.0, 4, None, "test_pallas_kernel BackwardEulerSoil(iters=2) at dt=600",
                 stepper=implicit("BackwardEulerSoil", model, 2))
    model, _, _ = build_stiff(**small)
    Y = {"soil": {"vartheta_l": torch.full((16, 256), 0.1, dtype=torch.float64, device=device),
                  "theta_i": torch.zeros((16, 256), dtype=torch.float64, device=device)}}
    kern = check_golden(ck, model, Y, 5.0, 4, None,
                        "test_pallas_kernel stiff infiltration at 20x CFL, TRBDF2Soil(iters=2)",
                        stepper=implicit("TRBDF2Soil", model, 2))
    if not (np.isfinite(kern["vartheta_l"]).all() and float(np.max(kern["vartheta_l"])) > 0.101):
        raise AssertionError("stiff infiltration: no finite wetting front")
    model, Y = build_kernel_test_model(VerticalFlux(0.0), VerticalFlux(0.0), seed=7, heterogeneous=True, **small)
    check_golden(ck, model, Y, 300.0, 4, None, "test_pallas_kernel heterogeneous parameters, TRBDF2Soil(iters=2)",
                 stepper=implicit("TRBDF2Soil", model, 2))
    outs = {}
    for tridiag in ("thomas", "pcr"):
        model, Y = build_kernel_test_model(VerticalFlux(0.0), VerticalFlux(0.0), **small)
        outs[tridiag] = check_golden(ck, model, Y, 600.0, 2, None,
                                     f"test_pallas_kernel TRBDF2Soil(iters=3, {tridiag!r}) at dt=600",
                                     stepper=implicit("TRBDF2Soil", model, 3, tridiag))
    rel = max(float(np.max(np.abs(outs["thomas"][k] - outs["pcr"][k]))) / (float(np.max(np.abs(outs["thomas"][k]))) or 1.0)
              for k in outs["thomas"])
    if not rel < 1e-9:
        raise AssertionError(f"PCR and Thomas kernels differ by {rel:.3e} of the field scale")
    print(f"[3 golden] f64 B4-trbdf2 vs B4-trbdf2-pcr (kernels): max deviation / field scale {rel:.3e} "
          f"(bar 1e-9)", flush=True)

    variants = ({}, {"coefficient_update": "step"}, {"freeze_thaw": FreezeThaw(tau=60.0)},
                {"freeze_thaw": EquilibriumFreezeThaw()})
    for dtype in (torch.float64, torch.float32):
        for kw in variants:
            model, Y = build_variant_model(1000, dtype, device, seed=7)
            model = dataclasses.replace(model, **kw)
            kern, plain, shares = check_variant(ck, model, Y, 5.0, 8, 2.0, f"variant {dtype} {kw}",
                                                ("vartheta_l", "rho_e_int"))
            print(f"[3 variant] {str(dtype)[6:]} {ck.make_fused_column_run(model).name} ncol=1000 "
                  f"Dirichlet/flux/callable BCs, per-column params, viscosity+impedance, ice: kernel vs "
                  f"plain max abs {_max_abs(kern, plain):.3e}; change error / largest change "
                  f"{_fmt(shares)} (bar {INCREMENT_RTOL[dtype]:g})", flush=True)
        # the water-only and heat-only branches and TR-BDF2 on them
        for model, Y0, stepper, dt, n, what, moving in branch_variants(dtype, device):
            name = ck.make_fused_column_run(model, stepper).name
            kern, plain, shares = check_variant(ck, model, _clone(Y0), dt, n, 2.0,
                                                f"variant {dtype} {name}", moving, stepper=stepper)
            print(f"[3 variant] {str(dtype)[6:]} {name} ncol=1000 {what}: kernel vs plain max abs "
                  f"{_max_abs(kern, plain):.3e}; change error / largest change {_fmt(shares)} "
                  f"(bar {INCREMENT_RTOL[dtype]:g})", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add phase 7: repeated timings, tile sweep, clock, profiler")
    parser.add_argument("--forced-only", action="store_true",
                        help="run phases 1, 2 and 11 only (the forced path, kernel mode B7)")
    parser.add_argument("--grid-only", action="store_true",
                        help="run phases 1, 2 and 12 only (the regional grid, kernel modes B1-batched and B8), "
                             "with phase 6's times of its paths")
    parser.add_argument("--adaptive-only", action="store_true",
                        help="run phases 1, 2 and 13 only (adaptive stepping, kernel modes B1-dt and B4+B5)")
    parser.add_argument("--cli-only", action="store_true",
                        help="run phases 1, 2 and 15 only (the run-file CLI and the explicit steppers of "
                             "rk_kernel.cu)")
    parser.add_argument("--seed", type=int, default=0, help="seed of phase 15b's per-column Ksat")
    parser.add_argument("--compare-with", metavar="PARENT",
                        help="after phases 1 and 2, hold this tree's registers and B1's kernel time to the tree at "
                             "PARENT (an unpacked git archive), built and timed in turns")
    parser.add_argument("--land-only", action="store_true",
                        help="run phases 1, 2, 10 and 16 only (the land path and the cold land path, kernel modes "
                             "B5 and B6 with and without the step policies), with phase 6's times of phase 10's "
                             "paths")
    parser.add_argument("--cold-forced-only", action="store_true",
                        help="run phases 1, 2 and 17 only (cold forced and water-only land: the land policy "
                             "instances with forcing rows, the water-only LandModel, the implicit steppers' policies "
                             "under a MOST top), with phase 6's times of 17d's paths")
    parser.add_argument("--land-rk-only", action="store_true",
                        help="run phases 1, 2 and 18 only (the explicit steppers under a MOST top and a LandModel, the "
                             "LandModel run files, the implicit steppers' policies on the water-only branch), with "
                             "phase 6's times of 18a's paths")
    parser.add_argument("--land-columns-only", action="store_true",
                        help="run phases 1, 2 and 19 only (per-column BC kinds and geometry in the land modes under "
                             "every explicit stepper: catchment.py's storm at its regolith depth, the 48 column "
                             "instances)")
    parser.add_argument("--soil-columns-only", action="store_true",
                        help="run phases 1, 2 and 20 only (per-column BC kinds and geometry in the plain-soil modes "
                             "under every explicit stepper and implicit step policy: the regional hour with no ice, "
                             "its SSPRK104 run file, the 44 new instances)")
    parser.add_argument("--most-columns-only", action="store_true",
                        help="run phases 1, 2 and 21 only (per-column BC kinds and geometry under the implicit "
                             "steppers with a MOST top: 17d's cold column with them, the flagship run file's soil, "
                             "the 24 new instances, the implicit no-ice column instances on the icy state)")
    parser.add_argument("--grad-only", action="store_true",
                        help="run phases 1, 2 and 14 only (the gradient path, kernel modes B9 and B4 + step "
                             "policies, with the times of its B4 + policy instances)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    global T_START
    t_start = T_START = time.perf_counter()
    sys.path.insert(0, HERE)
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw, FreezeThaw
    from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
    from landhydrology_tpu_torch.timestepping import SSPRK33

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi("name,power.limit")
    device = torch.device("cuda", 0)
    print(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t = time.perf_counter()
    libs = ck.build_library(FIRST_SOURCES)
    for key in libs:
        ck.load_library(key)
    build_s = time.perf_counter() - t
    costs = op_costs(ck)
    print(f"[2 build] {', '.join(ck.SOURCES[n].name for n in FIRST_SOURCES)} -> sm_90a in {build_s:.3f} s "
          f"(one nvcc per source and float type, in parallel; "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in ck.BUILD_SECONDS.items())}); "
          f"registers per thread (ptxas): {registers(ck, libs)}; spill stores in bytes (ptxas; the "
          f"instances without any left out): {({k: v for k, v in spill_stores(ck, libs).items() if v}) or 'none'}; "
          f"FP instructions per call (cuobjdump -sass, fast path): " + "; ".join(
              f"{str(d)[6:]} " + ", ".join(f"{k} {v}" for k, v in c.items()) for d, c in costs.items()),
          flush=True)
    global LATER_BUILD
    later = LATER_BUILD = LaterBuild(ck)
    later.start()

    gc = _load_golden_config()
    if args.compare_with:
        later.finish()
        compare_with(args.compare_with, smi)
        return finish([], smi, t_start)
    if args.forced_only:
        return finish(forced_phase(ck, gc, device, smi, costs), smi, t_start)
    if args.grid_only:
        return finish(time_paths(ck, costs, smi, grid_phase(ck, costs, smi, device, t_start)), smi, t_start)
    if args.adaptive_only:
        return finish(adaptive_main(ck, gc, costs, smi, device, t_start), smi, t_start)
    if args.grad_only:
        later.finish()  # the plain soil's implicit policy instances (implicit_policy_kernel.cu)
        grad_entries = grad_main(ck, gc, costs, smi, device, t_start)
        _mark(t_start, "phase 14")
        return finish(grad_entries, smi, t_start)
    if args.cli_only:
        later.finish()  # 15a's implicit no-ice instances (implicit_policy_kernel.cu)
        cli_entries = cli_main(ck, costs, smi, device, args.seed, t_start)
        _mark(t_start, "phase 15")
        return finish(cli_entries, smi, t_start)
    if args.cold_forced_only:
        later.finish()
        # 16a's checks of the land policy instances with step-indexed rows, which 17a completes
        cold_checked = {dtype: cold_checks(ck, dtype, device) for dtype in (torch.float64, torch.float32)}
        _mark(t_start, "phase 16a")
        cold_entries, cold_paths = cold_forced_phase(ck, costs, smi, device, t_start, cold_checked, {})
        _mark(t_start, "phase 17")
        return finish(time_paths(ck, costs, smi, cold_paths) + cold_entries, smi, t_start)
    if args.land_rk_only:
        later.finish()
        rk_entries, rk_paths = land_rk_phase(ck, costs, smi, device, t_start)
        _mark(t_start, "phase 18")
        return finish(time_paths(ck, costs, smi, rk_paths) + rk_entries, smi, t_start)
    if args.land_columns_only:
        later.finish()
        columns_entries = land_columns_phase(ck, costs, smi, device, t_start)
        _mark(t_start, "phase 19")
        return finish(columns_entries, smi, t_start)
    if args.soil_columns_only:
        later.finish()
        soil_entries = soil_columns_phase(ck, costs, smi, device, t_start)
        _mark(t_start, "phase 20")
        return finish(soil_entries, smi, t_start)
    if args.most_columns_only:
        later.finish()
        most_entries = most_columns_phase(ck, costs, smi, device, t_start)
        _mark(t_start, "phase 21")
        return finish(most_entries, smi, t_start)
    if args.land_only:
        land_paths = land_phase(ck, gc, device, smi)
        _mark(t_start, "phase 10")
        later.finish()
        cold_entries, _, _ = cold_phase(ck, costs, smi, device, t_start)
        _mark(t_start, "phase 16")
        return finish(time_paths(ck, costs, smi, land_paths) + cold_entries, smi, t_start)

    # ---- 3: goldens in f64 through the kernels, and variants ----
    golden_phase(ck, gc, device)
    _mark(t_start, "phase 3")

    # ---- 4 and 5: the main paths at full width ----
    paths = []  # (model, start state, dt, steps per launch, launches, error, stepper)
    for dtype in (torch.float32, torch.float64):
        stage_final = None
        for kw in ({}, {"assume_no_ice": True}, {"coefficient_update": "step"},
                   {"coefficient_update": "step", "assume_no_ice": True}):
            model, Y0, Ya = build_bench_model(NZ, NCOL, dtype, device)
            model = dataclasses.replace(model, **kw)
            # f64 held by its first launch (phase 20's cut of plain launches); f32's change error, 4e-2 of the
            # change over the path against the bar of 0.1, is too near it for a shorter launch
            kern, launches, err, _ = drive_path(ck, model, Y0, Ya, DT, N_STEPS, SPC, "4 main",
                                                ("vartheta_l", "rho_e_int"),
                                                plain_steps=SPC if dtype == torch.float64 else None)
            if not kw:
                stage_final = kern["vartheta_l"]
            if kw.get("coefficient_update") == "step":
                # bench.py's max_dev_lagged, held to its bar 1e-2.  In f64 the
                # deviation must also exceed 5x the change bar, so a kernel that
                # recomputed the coefficients per stage fails _check_increment;
                # in f32 the two trajectories can agree to rounding.
                dev = float(np.max(np.abs(kern["vartheta_l"] - stage_final)))
                share = dev / float(np.max(np.abs(kern["vartheta_l"] - _np(Y0)["vartheta_l"])))
                if not dev < 1e-2:
                    raise AssertionError(f"lagged run deviates from the stage run by {dev}")
                if dtype == torch.float64 and not share > 5 * INCREMENT_RTOL[dtype]:
                    raise AssertionError(f"lagged run is the stage run to {share:.3e} of the change")
                print(f"[4 main] {str(dtype)[6:]} {ck.make_fused_column_run(model).name} max_dev_lagged "
                      f"(max |vartheta_l| deviation from the stage run) {dev:.3e} (bench.py bar 1e-2), "
                      f"{share:.3e} of the largest change", flush=True)
            paths.append((model, Y0, DT, SPC, launches, err, SSPRK33()))
        for freeze in (FreezeThaw(tau=60.0), EquilibriumFreezeThaw()):
            model, Y0, Ya, dt = build_freeze_wide(gc, dtype, device, freeze)
            change_of, moving = None, ("vartheta_l", "theta_i", "rho_e_int")
            if dtype == torch.float32 and isinstance(freeze, EquilibriumFreezeThaw):
                # held by its first launch since phase 20's cut: the f32 projection's partition spread does not
                # shrink with the change (phase 19's call 3), so the change bar holds the total water and
                # rho_e_int, which no projection moves (as 17d's f32 equilibrium path), and _check_freeze the state
                change_of, moving = unpartitioned(model), ("water", "rho_e_int")
            # f64 held by a launch of a quarter of the path (phase 21's cut of plain launches: were half, over
            # which its change errors sat at 1e-15 to 1e-10 of the change against the bar of 1e-9)
            kern, launches, err, _ = drive_path(ck, model, Y0, Ya, dt, FREEZE_STEPS, FREEZE_STEPS // 2,
                                                "5 freeze", moving, change_of=change_of,
                                                plain_steps=FREEZE_STEPS // (4 if dtype == torch.float64 else 2))
            ice = float(np.max(kern["theta_i"]))
            if not ice > 1e-4:
                raise AssertionError(f"freeze at width: no ice formed (max theta_i {ice})")
            print(f"[5 freeze] {str(dtype)[6:]} {ck.make_fused_column_run(model).name} max theta_i "
                  f"{ice:.4e} (> 1e-4: ice formed)", flush=True)
            paths.append((model, Y0, dt, FREEZE_STEPS // 2, launches, err, SSPRK33()))
        torch.cuda.empty_cache()

    _mark(t_start, "phases 4 and 5")

    # ---- 8: the stiff path at full width (bench.py's implicit path) ----
    points = NZ * NCOL
    for dtype in (torch.float32, torch.float64):
        model, Y0, Ya = build_stiff(NZ, NCOL, dtype, device)
        dt_exp = stiff_dt_explicit(model, Y0)
        dt_imp = STIFF_FACTOR * dt_exp
        finals, walls = {}, {}
        for tridiag in ("thomas", "pcr"):
            st = implicit("TRBDF2Soil", model, 2, tridiag)
            kern, launches, err, walls[tridiag] = drive_path(
                ck, model, Y0, Ya, dt_imp, STIFF_STEPS, STIFF_STEPS, "8 stiff", ("vartheta_l",), stepper=st
            )
            finals[tridiag] = kern["vartheta_l"]
            paths.append((model, Y0, dt_imp, STIFF_STEPS, launches, err, st))
        n_exp = STIFF_STEPS * STIFF_FACTOR
        kern, launches, err, walls["explicit"] = drive_path(
            ck, model, Y0, Ya, dt_exp, n_exp, STIFF_FACTOR, "8 stiff", ("vartheta_l",), plain_steps=STIFF_FACTOR
        )  # held by its first launch (phase 19's cut of plain launches: were all eight)
        paths.append((model, Y0, dt_exp, STIFF_FACTOR, launches, err, SSPRK33()))
        tag = str(dtype)[6:]
        for tridiag, v_imp in finals.items():
            rmse = float(np.sqrt(np.mean((v_imp - kern["vartheta_l"]) ** 2)))
            dev = float(np.max(np.abs(v_imp - kern["vartheta_l"])))
            if not (np.isfinite(v_imp).all() and rmse < 1e-2):
                raise AssertionError(f"stiff path {tag} {tridiag}: RMSE {rmse} against the explicit run")
            print(f"[8 stiff] {tag} TR-BDF2 ({tridiag}) vs SSPRK33 at the matched horizon "
                  f"{STIFF_STEPS * dt_imp!r} s: RMSE {rmse:.4e} (bench.py bar 1e-2), max deviation {dev:.4e}",
                  flush=True)
        rates = {k: points * (n_exp if k == "explicit" else STIFF_STEPS) / (w / 1e3) for k, w in walls.items()}
        print(f"[8 stiff] {tag} dt_exp {dt_exp!r} s, dt_imp {dt_imp!r} s; Simulation.run wall ms "
              + ", ".join(f"{k} {w:.3f}" for k, w in walls.items())
              + "; end to end grid-points/s " + ", ".join(f"{k} {r:.4e}" for k, r in rates.items())
              + "; simulated s per wall s " + ", ".join(
                  f"{k} {STIFF_STEPS * dt_imp / (w / 1e3):.4e}" for k, w in walls.items()) + f" on {smi}",
              flush=True)
        call, tables, wall, kernel = host_per_launch(ck, model, Y0, Ya, dt_imp, STIFF_STEPS,
                                                     implicit("TRBDF2Soil", model, 2))
        print(f"[8 stiff] {tag} TR-BDF2 (thomas) host per launch: call {call:.3f} ms, BC and profile "
              f"tables alone {tables:.3f} ms; warm Simulation.run of 5 launches {wall:.3f} ms against "
              f"{kernel:.3f} ms of kernel time", flush=True)
        torch.cuda.empty_cache()

    _mark(t_start, "phase 8")

    # ---- 9: the other new modes at full width ----
    for dtype in (torch.float32, torch.float64):
        model, Y0, Ya = build_heat_only(NZ, NCOL, dtype, device, seed=5)
        # each path held by its first launch (phase 20's cut of plain launches: their change errors sat 200x or
        # more under the bar over the whole path)
        for st, dt, n, spc in ((SSPRK33(), 10.0, N_STEPS, SPC), (implicit("TRBDF2Soil", model, 2), 600.0, 16, 8)):
            _, launches, err, _ = drive_path(ck, model, Y0, Ya, dt, n, spc, "9 modes", ("rho_e_int",), stepper=st,
                                             plain_steps=spc)
            paths.append((model, Y0, dt, spc, launches, err, st))
        model, Y0, Ya = build_bench_model(NZ, NCOL, dtype, device)
        for name in ("TRBDF2Soil", "BackwardEulerSoil", "BackwardEulerRichards"):
            st = implicit(name, model, 2)
            _, launches, err, _ = drive_path(ck, model, Y0, Ya, 60.0, 16, 8, "9 modes",
                                             ("vartheta_l", "rho_e_int"), stepper=st, plain_steps=8)
            paths.append((model, Y0, 60.0, 8, launches, err, st))
        model, Y0, Ya = build_stiff(NZ, NCOL, dtype, device)
        dt_imp = STIFF_FACTOR * stiff_dt_explicit(model, Y0)
        st = implicit("BackwardEulerRichards", model, 2)
        _, launches, err, _ = drive_path(ck, model, Y0, Ya, dt_imp, STIFF_STEPS, STIFF_STEPS, "9 modes",
                                         ("vartheta_l",), stepper=st)
        paths.append((model, Y0, dt_imp, STIFF_STEPS, launches, err, st))
        torch.cuda.empty_cache()

    _mark(t_start, "phase 9")

    # ---- 10: the land path (bench.py's `land` path), kernel modes B5 and B6 ----
    paths += land_phase(ck, gc, device, smi)
    _mark(t_start, "phase 10")

    # ---- 11: the forced-reanalysis path, kernel mode B7 ----
    forced_entries = forced_phase(ck, gc, device, smi, costs)
    _mark(t_start, "phase 11")

    # ---- 12: the regional grid, kernel modes B1-batched and B8 ----
    paths += grid_phase(ck, costs, smi, device, t_start)
    _mark(t_start, "phase 12")

    # ---- 13: adaptive stepping, kernel modes B1-dt and B4+B5(+B7) ----
    forced_entries += adaptive_main(ck, gc, costs, smi, device, t_start)
    _mark(t_start, "phase 13")

    # ---- 14: the gradient path, kernel modes B9 and B4 + step policies ----
    later.finish()  # from here on the plain soil's implicit policy instances (implicit_policy_kernel.cu) run
    forced_entries += grad_main(ck, gc, costs, smi, device, t_start)
    _mark(t_start, "phase 14")

    # ---- 15: the run-file CLI and the explicit steppers of rk_kernel.cu ----
    ahead = CliAhead(device, args.seed)  # 15b's and 18b's CLIs, run beside 17a's checks
    forced_entries += cli_main(ck, costs, smi, device, args.seed, t_start, ahead)
    _mark(t_start, "phase 15")

    # ---- 16: the cold land path, kernel modes B5/B6 with freeze-thaw or no ice ----
    cold_entries, cold_checked, cold_probes_of = cold_phase(ck, costs, smi, device, t_start)
    forced_entries += cold_entries
    _mark(t_start, "phase 16")

    # ---- 17: cold forced and water-only land, B5/B6 + B7 and B4+B5 with the step policies ----
    ahead.start()
    cold_entries, cold_paths = cold_forced_phase(ck, costs, smi, device, t_start, cold_checked, cold_probes_of,
                                                 lambda: ahead.check(ck, costs, smi, device))
    paths += cold_paths
    forced_entries += cold_entries
    _mark(t_start, "phase 17")

    # ---- 18: the explicit steppers under MOST and a LandModel, the water-branch policies ----
    rk_entries, rk_paths = land_rk_phase(ck, costs, smi, device, t_start, ahead)
    paths += rk_paths
    forced_entries += rk_entries
    _mark(t_start, "phase 18")

    # ---- 19: per-column BC kinds and geometry in the land modes, every explicit stepper ----
    forced_entries += land_columns_phase(ck, costs, smi, device, t_start)
    _mark(t_start, "phase 19")

    # ---- 20: per-column BC kinds and geometry in the plain-soil modes, every stepper and step policy ----
    forced_entries += soil_columns_phase(ck, costs, smi, device, t_start)
    _mark(t_start, "phase 20")

    # ---- 21: per-column BC kinds and geometry under the implicit steppers with a MOST top ----
    forced_entries += most_columns_phase(ck, costs, smi, device, t_start)
    _mark(t_start, "phase 21")

    # ---- 6: times at the main-path shapes, in turns ----
    entries = time_paths(ck, costs, smi, paths)
    _mark(t_start, "phase 6")
    del paths
    entries += forced_entries
    torch.cuda.empty_cache()

    if args.profile:
        for coefficient_update in ("stage", "step"):
            for dtype in (torch.float32, torch.float64):
                profile_main_path(dtype, device, smi, coefficient_update)
                torch.cuda.empty_cache()
    return finish(entries, smi, t_start)


def time_paths(ck, costs, smi, paths):
    """Phase 6: each path's kernel and plain version timed at its shape, in
    turns, beside its bound; returns the kernel records."""
    entries = []
    for model, Y0, dt, spc, launches, err, stepper in paths:
        kernel_ms, plain_ms, probes = time_mode(ck, model, Y0, dt, spc, stepper)
        entries.append(time_record(ck, costs, smi, model, Y0, dt, spc, stepper, launches, err, kernel_ms,
                                   plain_ms, probes))
    return entries


def time_record(ck, costs, smi, model, Y0, dt, spc, stepper, launches, err, kernel_ms, plain_ms, probes,
                tag="6 time"):
    """Print a path's times ``kernel_ms`` (two samples) and ``plain_ms``
    (one or two samples) beside its bound; returns its kernel record."""
    from landhydrology_tpu_torch.models.soil.freeze_thaw import EquilibriumFreezeThaw

    k1, k2 = kernel_ms
    ms = (k1 + k2) / 2
    samples = plain_ms
    plain_ms = sum(samples) / len(samples)
    dtype = model.float_dtype
    mode = ck.kernel_mode(model, stepper)
    run = ck.make_fused_column_run(model, stepper, dt=dt, steps_per_call=spc)
    name = run.name
    iters = getattr(stepper, "iters", 2)
    nz, ncol = next(iter(Y0["soil"].values())).shape
    freeze = getattr(model, "soil", model).freeze_thaw
    n_iter = freeze.n_iter if isinstance(freeze, EquilibriumFreezeThaw) else 60
    b_ms, b_by = bound_ms(ck, costs, mode, dtype, nz * ncol, spc, n_iter, iters, ncol, probes,
                          read_values=per_column_values(run, nz, ncol, dtype))
    cell_steps = nz * ncol * spc
    traffic = ""
    if probes is not None:
        rounds = 20 if dtype == torch.float64 else 4
        traffic = f"; MOST probes per solve {probes:.4f} of {rounds * 8} ({probes / rounds:.4f} per round)"
    if mode & ck.MODE_IMPLICIT:
        values = scratch_values_per_cell_step(ck, mode, iters)
        nbytes = values * (torch.finfo(dtype).bits // 8)
        traffic = (f"; scratch and state traffic {values} values = {nbytes} B per cell-step, "
                   f"{1e3 * cell_steps * nbytes / HBM_BYTES_PER_S:.3f} ms at the HBM rate if none stayed in L2")
    count = "one sample" if len(samples) == 1 else f"{len(samples)} samples"
    plain_steps = _PATH_CHECKED_STEPS.get(_path_key(model, Y0, dt, spc, stepper), spc)
    plain_at = None if plain_steps == spc else f"the path's check: nz={nz} x {ncol}, {plain_steps} steps"
    plain = (f"{'/'.join(f'{p:.3f}' for p in samples)} ms ({count}"
             + (f" of {plain_steps} steps" if plain_at else "")
             + f", {nz * ncol * plain_steps / (plain_ms / 1e3):.4e} grid-points/s)")
    print(f"[{tag}] {str(dtype)[6:]} {name} {spc} steps nz={nz} ncol={ncol}: kernel {k1:.3f}/{k2:.3f} ms "
          f"({cell_steps / (ms / 1e3):.4e} grid-points/s), plain {plain}, bound {b_ms:.3f} ms by {b_by} "
          f"({b_ms / ms:.3f} of the kernel's time){traffic} on {smi}", flush=True)
    kernel, source = kernel_of(ck, mode, dtype)
    return {
        "name": f"{kernel}<{str(dtype)[6:].replace('float', 'f')}, {name}>",
        "route": "cuda",
        "source": source,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call computes these steps
        **({"plain_at": plain_at} if plain_at else {}),
    }


#: run in a subprocess from a tree: its build's registers and spill stores, and the kernel ms of B1 and of
#: COMPARE_LAND's SSPRK33 land instances (each at its width, SPC steps per launch), and of COMPARE_TILE's modes at
#: the regional hour's shape (GRID_SPC steps per launch)
_COMPARE_SNIPPET = r"""
import dataclasses, json, sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from landhydrology_tpu_torch.ops.cuda import column_kernel as ck
libs = ck.build_library()
out = {{"registers": cs.registers(ck, libs), "spills": cs.spill_stores(ck, libs), "ms": {{}}}}
gc = cs._load_golden_config()
def timed(key, model, Y, dt, t0=0.0, spc=cs.SPC):
    run = ck.make_fused_column_run(model, dt=dt, steps_per_call=spc)
    assert run.name == key.split(" ", 1)[1], (run.name, key)
    run(Y, t0)
    reps = max(5, -(-200 // int(cs._time_ms(lambda: run(Y, t0), 2) + 1)))  # samples of 200 ms or more
    out["ms"][key] = [cs._time_ms(lambda: run(Y, t0), reps) for _ in range(4)]
for dtype in (torch.float32, torch.float64):
    tag = str(dtype)[6:]
    model, Y, _ = cs.build_bench_model(cs.NZ, cs.NCOL, dtype, "cuda")
    timed(tag + " B1", model, Y, cs.DT)
    for name in {land!r}:
        if name in ("B5", "B6", "B2+B6-step"):
            step = "step" if "-step" in name else "stage"
            model, Y, _ = cs.build_land_model(cs.NZ, cs.NCOL, dtype, "cuda", step, step)
            if name == "B5":
                model, Y = model.soil, {{"soil": Y["soil"]}}
            timed(tag + " " + name, model, Y, cs.DT)
        elif name.endswith("-water"):
            model, Y = cs.build_storm(dtype, "cuda", name)
            timed(tag + " " + name, model, Y, cs.STORM_DT, cs.STORM_T0)
        else:
            model, Y, _, dt = cs.build_cold_land(gc, dtype, "cuda", name)
            timed(tag + " " + name, model, Y, dt)
        del model, Y
        torch.cuda.empty_cache()
    for name in {tile!r}:
        model, Y, _, _ = cs.build_regional(cs.GRID_NZ, cs.GRID_NCOL, dtype, "cuda", variable_depth=name.endswith("+B8"))
        model = dataclasses.replace(model, assume_no_ice="-no-ice" in name)
        timed(tag + " " + name, model, Y, cs.GRID_DT, spc=cs.GRID_SPC)
        del model, Y
        torch.cuda.empty_cache()
print("COMPARE " + json.dumps(out))
"""


#: the instances whose code a repair changed (their registers may differ from the parent's): none in this tree
REPAIRED = ()
#: the parent's instances that the column-tile kernel replaced (``csrc/tile_columns_kernel.cu``): ``column_kernel.cu``'s
#: SSPRK33 B1 with MODE_COLUMNS and ``rk_columns_kernel.cu``'s B1 and B1-no-ice; their registers are not held, their
#: modes are timed in both trees (``COMPARE_TILE``)
REDESIGNED = ("B1+kinds+B8", "rk:B1+kinds+B8", "rk:B1-no-ice+kinds+B8")
#: the column-tile kernel's modes ``--compare-with`` times in both trees at the regional hour's shape (phase 12 and
#: 20a: nz=48 x 131,072, GRID_SPC steps of GRID_DT per launch, SSPRK33), on the model's grid and the variable-depth
#: twin's; each must be faster than the other tree's instance
COMPARE_TILE = ("B1+kinds", "B1+kinds+B8", "B1-no-ice+kinds", "B1-no-ice+kinds+B8")
#: the SSPRK33 land instances ``--compare-with`` times in both trees (their body also holds the stage-table
#: stepping since this tree): the MOST soil column, the reference and production LandModel, the water-only
#: LandModel, rate freeze-thaw under a LandModel, the equilibrium projection under MOST
COMPARE_LAND = ("B5", "B6", "B2+B6-step", "B6-pond-water", "B6+B3-rate", "B5+B3-eq")


def compare_with(parent, smi) -> None:
    """``--compare-with PARENT``: this tree and the tree at ``PARENT`` (an
    unpacked ``git archive`` of the parent commit), each in a subprocess in
    turns (parent, this, this, parent), each with its own kernels, built
    before any run is timed (this tree's by ``main``, the parent's in a
    subprocess of its own: built in the first timed run, they left the card
    idle for minutes before that run alone): every
    instance the parent builds keeps its registers per thread (ptxas) here
    but those of ``REPAIRED``; the new instances with ``MODE_COLUMNS``
    (``rk:<mode>+kinds+B8``, ``<implicit mode>+kinds+B8``) have their
    registers and spill stores printed beside the parent's twins without
    it; B1's and ``COMPARE_LAND``'s kernel times per 32-step launch at
    their widths (CUDA events, four samples per run, each of five launches
    or of 200 ms, whichever is longer) are within 2% of the parent's, f32
    and f64.  The instances of ``REDESIGNED`` are the column-tile kernel's
    here: their registers and spill stores are printed beside the new
    instances', and ``COMPARE_TILE``'s modes, timed alike per 48-step launch
    at the regional hour's shape, must be faster here than in the
    parent."""
    runs = []
    build = ("import sys; sys.path.insert(0, {tree!r}); from landhydrology_tpu_torch.ops.cuda import column_kernel; "
             "column_kernel.build_library()")
    for tree, code in [(parent, build)] + [(t, _COMPARE_SNIPPET) for t in (parent, HERE, HERE, parent)]:
        proc = subprocess.run([sys.executable, "-c", code.format(tree=os.path.abspath(tree), land=COMPARE_LAND,
                                                                 tile=COMPARE_TILE)],
                              cwd=tree, capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise AssertionError(f"compare {tree}: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
        if code is _COMPARE_SNIPPET:
            runs.append(json.loads(proc.stdout.split("COMPARE ", 1)[1]))
    before, after = runs[0]["registers"], runs[1]["registers"]
    spills_before, spills_after = runs[0]["spills"], runs[1]["spills"]
    repaired = {k: (v, after.get(k)) for k, v in before.items() if k.split(", ", 1)[1] in REPAIRED}
    redesigned = {k: (v, spills_before.get(k, 0)) for k, v in before.items() if k.split(", ", 1)[1] in REDESIGNED}
    changed = {k: (v, after.get(k)) for k, v in before.items()
               if after.get(k) != v and k not in repaired and k not in redesigned}
    spills_changed = {k: (v, spills_after.get(k, 0)) for k, v in spills_before.items()
                      if spills_after.get(k, 0) != v and k not in redesigned}
    new = sorted(set(after) - set(before))
    tile = [k for k in new if k.split(", ", 1)[1].startswith("tile:")]
    print(f"[compare] redesigned: the parent's {', '.join(f'{k} {r} registers / {b} B spill stores' for k, (r, b) in redesigned.items())} "
          f"-> the column-tile kernel's {', '.join(f'{k} {after[k]} / {spills_after.get(k, 0)}' for k in tile)}",
          flush=True)
    print(f"[compare] registers: {len(before)} instances of the parent, {len(after)} here; changed "
          f"{changed or 'none'}; spill stores changed {spills_changed or 'none'}; repaired (parent, here): "
          f"{repaired}; new: {new}", flush=True)
    tables = [k for k in new if k.endswith("+kinds+B8") and k not in tile]
    print(f"[compare] {len(tables)} new instances with MODE_COLUMNS, registers / spill-store bytes (the parent's "
          "instance of the mode without it -> this one): " + "; ".join(
              f"{k} {before.get(k.replace('+kinds+B8', ''))}->{after[k]} / "
              f"{spills_before.get(k.replace('+kinds+B8', ''), 0)}->{spills_after.get(k, 0)}" for k in tables),
          flush=True)
    if changed:
        raise AssertionError(f"the parent's instances changed registers: {changed}")
    missed, slower = [], []
    for key in runs[0]["ms"]:
        ms_parent = [m for r in (runs[0], runs[3]) for m in r["ms"][key]]
        ms_here = [m for r in (runs[1], runs[2]) for m in r["ms"][key]]
        ratio = float(np.median(ms_here)) / float(np.median(ms_parent))
        redesign = key.split(" ", 1)[1] in COMPARE_TILE
        bar = "below 1: the column-tile kernel against the parent's instance" if redesign else "1 +- 0.02"
        print(f"[compare] {key} {GRID_SPC if redesign else SPC} steps per launch: parent ms "
              f"{', '.join(f'{m:.3f}' for m in ms_parent)}; this tree {', '.join(f'{m:.3f}' for m in ms_here)}; "
              f"median ratio {ratio:.4f} (bar {bar}) on {smi}", flush=True)
        if redesign and not ratio < 1.0:
            slower.append(f"{key} {ratio:.4f}")
        elif not redesign and not abs(ratio - 1.0) <= 0.02:
            missed.append(f"{key} {ratio:.4f}")
    if missed or slower:
        raise AssertionError(f"kernel time off the parent's by more than 2%: {', '.join(missed) or 'none'}; the "
                             f"column-tile kernel not faster than the parent's instance: {', '.join(slower) or 'none'}")


#: the sources phases 3-15 launch, which phase 2 builds (the column-tile kernel's for phase 12's regional hour);
#: the others compile in the background (``LaterBuild``) while those phases run
FIRST_SOURCES = ("column_kernel", "implicit_kernel", "land_kernel", "rk_kernel", "tile_columns_kernel")
#: the run's ``LaterBuild`` (``main`` starts it)
LATER_BUILD = None
#: the background build's compiles at a time, and its sources in the order it starts them, the longest first
#: (their seconds in the calls of phase 20's PR, all twenty compiles at once: 130-273 s for the implicit and land
#: policy sources in f64, 58-92 s for the others; phase 21's source alone 43.4 / 58.4 s, f32 / f64).  Four at a
#: time ran phases 3-8 in 121.9 s against 174.3 s with six (two runs on alike H100 hosts); phase 21's source last
#: compiled alone beside phases 10-11 and the build ended 319.5 s from its start, first 256.8 s (an H100 host)
LATER_JOBS = 4
LATER_ORDER = ("implicit_most_columns_kernel", "implicit_most_kernel", "implicit_columns_kernel",
               "implicit_policy_kernel", "land_policy_columns_kernel", "land_policy_rk_kernel", "land_policy_kernel",
               "implicit_branch_kernel", "land_columns_kernel", "land_rk_kernel", "rk_columns_kernel")


class LaterBuild(threading.Thread):
    """Phase 2's build of the sources not in ``FIRST_SOURCES``
    (``LATER_ORDER``), ``LATER_JOBS`` compiles at a time, in a thread whose
    ``nvcc`` processes run at nice 19 (the thread's own priority, which
    Linux gives the processes it starts).  The phases beside it run slower
    all the same (on an H100 host phase 3 took 62-78 s beside seven sources,
    28 s without, also with the build kept off two of the eight CPUs; beside
    ten sources' twenty compiles at once, phases 3-5 ran at a fifth to a
    third of their speed), but less than the build would take in front of
    them.  ``finish`` (before phase 14, and at the end) starts it if need
    be and waits for it, once, loads its libraries and prints their build
    seconds, registers and spill stores.  Not a daemon: the interpreter
    waits for the build on an early exit."""

    def __init__(self, ck):
        super().__init__()
        self.ck, self.libs, self.error, self.done = ck, None, None, False
        self.sources = tuple(name for name in ck.SOURCES if name not in FIRST_SOURCES)
        if sorted(self.sources) != sorted(LATER_ORDER):
            raise RuntimeError(f"LATER_ORDER {LATER_ORDER} does not list the sources {self.sources}")
        self.sources = LATER_ORDER

    def run(self):
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        try:
            self.libs = self.ck.build_library(self.sources, jobs=LATER_JOBS)
        except BaseException as error:  # raised in the main thread by finish
            self.error = error

    def finish(self):
        if self.done:
            return
        if self.ident is None:  # not started yet
            self.start()
        clock = time.perf_counter()
        self.join()
        self.done = True
        if self.error is not None:
            raise self.error
        for key in self.libs:
            self.ck.load_library(key)
        seconds = {k: v for k, v in self.ck.BUILD_SECONDS.items() if k in self.libs}
        print(f"[2 build, in the background] {', '.join(self.ck.SOURCES[n].name for n in self.sources)} -> sm_90a, "
              f"{LATER_JOBS} compiles at a time, "
              f"waited for {time.perf_counter() - clock:.3f} s ({', '.join(f'{k} {v:.1f} s' for k, v in seconds.items())} "
              f"from its start, at nice 19); registers per thread (ptxas): {registers(self.ck, self.libs)}; spill stores "
              f"in bytes: {({k: v for k, v in spill_stores(self.ck, self.libs).items() if v}) or 'none'}", flush=True)


def finish(entries, smi, t_start) -> int:
    """Print the run's time, the kernel records, the card and the result."""
    if LATER_BUILD is not None:
        LATER_BUILD.finish()
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
