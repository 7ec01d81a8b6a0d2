#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits nonzero):

  0. the card: name and power limit from nvidia-smi, torch and CUDA versions;
  1. build the kernels for sm_90a: K1/K2 from
     rigid_body_light_tpu_torch/csrc/rpy_pair_sweep.cu, K3 from
     near_sweep.cu, K4, its slab form and K4 tiles from
     ewald_real_sweep.cu, P from fma_peak.cu;
  2. K1 (symmetric sweep) against the plain PyTorch sweep in float64 on
     the card, wall and free, at the slice's 10,272 blob positions and a
     ragged 1,000-blob cloud straddling the wall-height floor: at 1 RHS
     through the mobility product, at 2 RHS (the form the Pallas kernel
     has, which the dispatch gives it from 65,025 blobs) on its pair
     terms; two launches bitwise equal at 1 and 2 RHS; then K1's time
     against the plain float32 sweep at the slice's shape;
  3. the same for K2 (ordered sweep): at 2 RHS, the slice's fused noise
     product, through the mobility product, at 1 RHS on its pair terms;
     and K1's time at 2 RHS beside K2's;
  4. the slice: 16 × shell_N_642 = 10,272 blobs above a wall (the JAX
     package's bench.py::seg_dispersed configuration), run_bd for 1 warm-up
     and 8 timed steps through the kernels, with the launch counts read
     around that run;
  5. one step through the kernels against one step through the plain
     float32 sweep, from identical draws;
  6. K3, the far field's near sweep (rigid_body_light_tpu_torch/csrc/
     near_sweep.cu, a symmetric sweep over unordered tile pairs), against
     its plain PyTorch version in float64 on the card, wall and free, 1 and
     2 RHS, at 10 × shell_N_2562 = 25,620 blobs on the slice's (12, 12, 3)
     grid, at a ragged two-clump cloud with empty cells straddling the
     wall-height floor, and at three far-apart clumps whose tiles have only
     their diagonal pair (one of them a partial last tile); then, at the
     at-scale slice's 102,480 blobs, K3 through its wrapper against the
     float64 plain sweep (wall, 1 and 2 RHS), two launches bitwise equal
     at 1 and 2 RHS, and K3's time against the plain float32 sweep and its
     bound;
  7. the far-field operator through K3 against the exact operator through
     K1 at the at-scale slice's 102,480 positions, wall; there, a 2-RHS
     exact product, which the dispatch sends to K1, its pair terms against
     K2's on the same inputs, and both kernels' times;
  8. the at-scale slice: 40 × shell_N_2562 = 102,480 blobs above a wall on
     the O(N) far field (the JAX package's bench.py::seg_farfield102k
     configuration), run_bd for 1 warm-up and 2 timed steps, with the
     launch counts read around that run;
  9. one far-field step through K3 against one through the plain float32
     near sweep, from identical draws, at 25,620 blobs;
 10. K4, the Ewald real-space sweep (rigid_body_light_tpu_torch/csrc/
     ewald_real_sweep.cu), against the plain sweep in float64 on the card
     (the same Chebyshev fit, float64 Clenshaw), 1 and 2 RHS: at the
     periodic slice's 10,272 blob positions and at a uniform cloud of
     10,272 blobs in its L = 14 box, and at 700 blobs in a (9, 11, 10) box
     with a = 0.45 at the default tolerance (another degree, a ragged n),
     and at 2,049 blobs in the slice's box (a last work-item row and
     column of one blob); two launches agree bitwise;
 11. K4's time at the periodic slice, 1 and 2 RHS, against the plain
     float32 sweep and its bound, and at 4× the blobs; the wave part's
     time and the whole operator's;
 12. the Ewald operator through K4 against the float64 operator with the
     closed-form scalars at the periodic slice, its wave part against the
     float64 wave part (full float32 matmuls, no TF32), and the operator's
     symmetry;
 13. the periodic slice: 16 × shell_N_642 = 10,272 blobs in a cubic L = 14
     box, ewald_tol 1e-4 (the JAX package's scripts/tpu_ewald_bench.py
     configuration), run_bd for 1 warm-up and 8 timed steps, with the
     launch counts read around that run;
 14. one periodic step through K4 against one through the plain float32
     sweep, from identical draws;
 15. P, the FP32 FMA peak probe (rigid_body_light_tpu_torch/csrc/
     fma_peak.cu), against its plain version, then the card's measured
     FP32 rate beside the nominal one;
 16. K1 at 409,600 blobs above a wall (a cloud at the dense slice's blob
     density; 3,200 tiles in 256 groups of 12 or 13), 1 and 2 RHS, against the
     float64 plain sweep on 256 sampled rows, two launches bitwise equal,
     its time, its scratch (O(n): one row and one column partial a tile of
     each block's groups) and torch.cuda.max_memory_allocated over the
     launch; K4 over tile groups (65,664 blobs) against its
     float64 plain sweep on 256 sampled rows, and K4's bitwise repeat
     there and at the periodic slice;
 17. the settled solve: at the geometry of scripts/data/settled_642.npz,
     one float32 solve with block_free and one with RAS from the same RHS
     (no slip, the settled forces) at gmres_tol 1e-5; RAS must take fewer
     iterations, the two U agree to 1e-4 of max|U|;
 18. the settled slice: 16 × shell_N_642 = 10,272 blobs from that
     checkpoint (the JAX package's bench.py::seg_settled configuration:
     RAS, adaptive Lanczos, gravity and wall repulsion), run_bd for 1
     warm-up and 20 timed steps through the kernels, with the launch
     counts read around that run, every residual below 10·gmres_tol;
 19. one settled step through the kernels against one through the plain
     float32 sweep, from identical draws;
 20. the step timer (utils/profiling.StepTimer) on the dense, far-field,
     periodic, settled and film (image_shells 2) slices: each part's own
     ms a step, the GMRES loop's among them; and the dense slice's steps/s
     with the timer on and off, in turns;
 21. K1 and K2's box forms (the pseudo-2D box's minimum-image wrap, and
     the exact image sum at image_shells 2) against the float64 plain
     sweep on the same float32 inputs, wall, 1 and 2 RHS: at the film
     slice's 10,272 positions (blob pairs exactly on the seams), at a
     ragged 1,000-blob cloud straddling the seams and the wall-height
     floor, and K1 at 66,000 blobs (its grouped kernel) on 256 sampled
     rows; two launches bitwise equal; their times at the film slice
     against the plain float32 sweep and the (2S+1)²-scaled bound;
 22. the film slice: the dense slice's 16 × shell_N_642 = 10,272 blobs in
     a (10, 10) box above the wall (examples/periodic_film.json's physics
     and solver: kBT 0.3, gravity, wall repulsion, Yukawa pairs, 8 Lanczos
     iterations), run_bd for 1 warm-up and 8 timed steps at image_shells 2
     and then 0, with the launch counts read around each run;
 23. one image_shells 2 film step through the kernels against one through
     the plain float32 sweep, from identical draws, at the slice's state
     after phase 22;
 24. K3's box form (the pseudo-2D film's minimum-image wrap of dx, dy and
     cyclic cell offsets) against the plain near sweep in float64 on the
     same float32 inputs and box, wall, 1 and 2 RHS, two launches bitwise
     equal: at the far-field film slice (the far-field slice's 40 ×
     shell_N_2562 = 102,480 blobs on an 8 × 5 lattice in the (20.8, 13.0)
     box it tiles, grid (16, 10, 3), p = 4, image_shells 6), at a ragged
     cloud across both seams and the wall-height floor, at a g = 4 grid
     with blob pairs on the seam tie and one ulp either side of it, and at
     a tile that meets itself across the seam; then its time at the slice
     against the plain float32 sweep, its bound and the open form's;
 25. the far-field film operator through K3 against the exact image sweep
     (K1's box form at image_shells 6 with the tail, plus the self
     images) at the slice, two of its products bitwise equal, the lattice
     build's time and peak memory; then
     run_bd on the slice for 1 warm-up and 2 timed steps, with the launch
     counts read around that run (K3 launched, K1/K2/K4 not; every
     residual below 10·gmres_tol), and the step timer's split of one more
     step (the lattice build's ms a step and share);
 26. one far-field film step through K3 against one through the plain
     float32 near sweep, from identical draws, at 10 × shell_N_2562 =
     25,620 blobs on a 5 × 2 lattice in the (13.0, 5.2) box, grid
     (10, 4, 3);
 27. K1's and K2's POLY forms (per-blob radii: the polydisperse fields,
     the wall terms at √(aᵢaⱼ)) against the float64 plain sweep with
     radii, wall and free, 1 and 2 RHS (K1 at 2 RHS on its pair terms),
     at the mixture slice's 10,296 positions and radii, at a ragged
     1,000-blob cloud with radii from {0.6, 1.1}·a straddling the
     wall-height floor, and at a cloud of near-coincident pairs of unequal
     radii (the overlap branch and the deep branch r < |aᵢ − aⱼ|); two
     launches bitwise equal; then both forms' times against their
     monodisperse forms at the same positions, the plain float32 sweep and
     their bounds;
 28. the mixture slice: 12 × shell_N_642 (blob radius a) + 16 ×
     shell_N_162 scaled by 0.5 with its own blob radius = 10,296 blobs
     above the wall (scripts/tpu_mixture_bench.py's mixture, the small
     species at run.py's per-species radius), multi.run_bd_multi for 1
     warm-up and 8 timed steps, with the launch counts read around that
     run (the POLY forms launched, the monodisperse forms not; every
     residual below 10·gmres_tol), and the step timer's split;
 29. one mixture step through the kernels against one through the plain
     float32 sweep, from identical draws;
 30. the JAX package's monodisperse mixture (the small species scaled by
     sep_642/sep_162 at blob radius a, no radii) and the dense slice, each
     1 warm-up and 8 timed steps, in the same run: their steps/s and
     ratio, beside the polydisperse mixture's;
 31. the mixture RAS preconditioner on the card (tests/test_multi.py's
     dense wall mixture, 6 × shell_N_12 + 3 × shell_N_42, float32,
     gmres_tol 1e-5): RAS takes fewer iterations than block_free and the
     two U agree within 1e-4 of max|U|;
 32. K3's POLY form (per-blob radii: the polydisperse pair fields, the
     wall terms at √(aᵢaⱼ)) against the float64 plain near sweep with
     radii on the same float32 inputs, wall and free, 1 and 2 RHS, two
     launches bitwise equal: at the far-field mixture slice (the far-field
     slice's 40 × shell_N_2562 and 40 × shell_N_162 scaled by 0.5 at its
     own blob radius in the lattice's gaps = 108,960 blobs, grid
     (12, 12, 3), p = 4), at a ragged cloud with radii {0.6, 1.1}·a and at
     150 close pairs of unequal radii; its POLY × BOX form at the film
     check set (10 + 10 bodies = 27,240 blobs in the (13.0, 5.2) box, grid
     (10, 4, 3)) and at a tile that meets itself across the seam; then both
     forms' times against their monodisperse forms at the same positions
     (in turns), the plain float32 sweep and their bounds;
 33. the polydisperse far field (the radius-split lattices: 2 free, 3
     wall) against the exact polydisperse operator (K1's POLY form) at the
     slice, two of its products bitwise equal, the lattice build's time and
     peak memory;
 34. the far-field mixture slice: multi.run_bd_multi for 1 warm-up and 2
     timed steps, with the launch counts read around that run (K3's POLY
     form launched; mono K3, K1, K2 and K4 not; every residual below
     10·gmres_tol), beside the monodisperse far-field slice's steps/s of
     phase 8, and the step timer's split of one more step;
 35. one far-field mixture step through K3's POLY form against one through
     the plain float32 sweep, from identical draws, at 10 + 10 bodies =
     27,240 blobs, in the open domain and in the film (image_shells 6,
     K3's POLY × BOX form);
 36. K1's and K2's POLY × BOX forms (per-blob radii in the pseudo-2D box,
     K1 with the self images at each blob's radius) against the float64
     plain sweep with radii, box and images on the same float32 inputs,
     wall and free, image_shells 0 and 2, 1 and 2 RHS, two launches
     bitwise equal: at the polydisperse film (the mixture slice's 10,296
     blobs in the film slice's (10, 10) box), at the ragged cloud and the
     150 close pairs of unequal radii in boxes they overfill (pairs across
     both seams); then their times at the film, in turns with the box and
     POLY forms at the same positions, the plain float32 sweep and their
     bounds;
 37. the polydisperse film through the run driver
     (rigid_body_light_tpu_torch.run.main on a JSON config with "species",
     "blob_radius", "file" placements, the box and image_shells 2): a
     warm-up chunk and a timed chunk of 8 steps, steps/s from the driver's
     own line, the launch counts read around it (the POLY × BOX forms
     launched, no other kernel form), every residual below 10·gmres_tol,
     |q| within 1e-5 of 1, the trajectory read back with every frame; then
     a resume from the chunk's checkpoint that appends a chunk with no gap;
 38. one polydisperse film step through the kernels against one through
     the plain float32 sweep, from identical draws, at the driver's final
     state, and the step timer's split there; the far-field mixture's
     film operator (phase 32's 27,240-blob
     film check set, image_shells 6) against the exact polydisperse image
     operator through K1's POLY × BOX form;
 39. drift_mode="em_exact" and lanczos_precond=False (the fused 2-RHS
     unpreconditioned noise) on the dense slice (run_bd) and the mixture
     (run_bd_multi): a step through the kernels against one through the
     plain float32 sweep from identical draws, and 1 + 3 steps with their
     steps/s; then the driver on examples/periodic_film.json and
     examples/sedimenting_suspension.json (copied, output_dir in a
     temporary directory, n_steps cut to one checkpoint chunk);
 40. the RigidBody API (numpy in and out) at the dense slice, config= its
     configuration with validate_config on: construction and the overlap
     diagnose's ms; each operator's ms a numpy call beside the same
     function's on device tensors, and the launches of one call (K1 alone
     under apply_M, apply_saddle, solve_mobility and solve_resistance, no
     plain sweep); apply_M against apply_M_dense in float64 (30,816²
     entries) and the plain float32 sweep; the resistance solve inverting
     the mobility solve within 10·gmres_tol; stochastic_step from given
     draws bitwise the stepper's (K1 and K2 launched); RigidBody.run
     against run_bd in turns; the below-wall RuntimeError on the card;
     a float64 instance's solve with no kernel launched;
 41. the RigidBody API at the far-field slice (102,480 blobs): the overlap
     diagnose's ms, apply_M, solve_mobility and one deterministic_step
     through K3 alone (K1 and K2 not launched), apply_M within 1e-2 of
     the exact operator (K1);
 42. the balanced split (ewald_rc 3.5: the tile sweep of
     rigid_body_light_tpu_torch/ops/ewald_cells.py through the kernel K4
     tiles, csrc/ewald_real_sweep.cu) at the periodic slice's 10,272
     positions, with the dense wave part and with the gridded wave part
     (ops/ewald_pme.py, p = 4), against the classic split through K4 at 1
     and 2 RHS within 2e-4 of max|U|; the tile sweep against the float64
     all-pairs sweep with the same cut, bitwise repeatable; the ms of the
     tile sweep, the gridded and dense wave parts, K4's classic operator
     and the balanced one; the neighbor widths, tiles, G and k-vectors;
 43. the JAX package's PME bench case (scripts/tpu_ewald_pme_bench.py,
     case 1: 102,400 uniform points in L = 30, a = 0.243553) at rc 3.5 and
     4.5 with p = 4 against the classic split through K4 (ROADMAP queue 3,
     fault 3): each operator's rel err, ms and peak memory, and its parts
     apart — the tile sweep on 256 sampled rows against the float64
     all-pairs sweep with the cut, the gridded wave part against the dense
     (K-chunked) wave sum;
 44. the balanced-split slice: 180 x shell_N_642 = 115,560 blobs on a
     6 x 6 x 5 lattice in a cubic L = 30 box (ewald_rc 3.5, ewald_grid_p
     4, the periodic slice's solver settings), run_bd for 1 warm-up and 2
     timed steps (every residual below 10·gmres_tol, |q| within 1e-5 of 1,
     K4 tiles launched and K4 not), the step timer's split of one more step
     with the mobility span divided into the tile lists, the tile kernel,
     the rest of the tile sweep, the gridded wave part and the rest; one
     step through the kernel against one with use_pallas=False (the plain
     tile sweep) from the same draws; then RigidBody.apply_M (numpy in and
     out) at the slice's positions beside the device function;
 45. the polydisperse periodic mixture: the mixture slice's 10,296 blobs
     and forces in a cubic L = 14 box with no wall (ewald_rc 3.5,
     ewald_grid_p 4): the operator with radii against the classic split
     with radii (the plain all-pairs sweep) at 1 and 2 RHS, then
     multi.run_bd_multi for 1 warm-up and 4 timed steps (K4 tiles
     launched, its POLY form; K4 not);
 46. the far field's band tier (farfield_band_p: cell offsets 2-3 at a
     higher order as batched float32 matmuls, no TF32) at
     scripts/tpu_farfield_bench.py's band case, 102,400 points: the slab
     above the wall, grid (10, 10, 5), at p = 4 + band 6, p = 4 and plain
     p = 6, and the free cube of side 30 (auto grid) at p = 4 + band 6
     and p = 4; each variant's prepare ms, ms an apply at 1 and 2 RHS and
     its far_band part, lattice and band bytes, peak memory, and
     max|dU|/max|U| against the exact product through K1; the band at
     least 4x tighter than p = 4 in both set-ups;
 47. the far-field slice with farfield_band_p 6 through run_bd (1 warm-up
     and 2 timed steps at gmres_tol 3e-4, which the two-tier estimate does
     not warn about) beside the same slice at p = 4 in the same run: steps/s,
     K3's launches a step, GMRES iterations and residuals (each below
     10·gmres_tol), the step timer's split with the far_band span; one
     band step through K3 against one through the plain near sweep, from
     the same draws, at 25,620 blobs;
 48. the polydisperse band at the far-field mixture (108,960 blobs): the
     operator against K1's exact POLY product beside p = 4's, and a
     run_bd_multi step after a warm-up;
 49. the adjoints at the dense slice: K1's autograd Function
     (rpy_cuda.MobilityApply) against autograd through the plain float32
     sweep at 4 bodies (F-bar within 5e-6, r-bar within 1e-5 of max), its
     forward and backward ms, launches and peak memory at 10,272 blobs;
     the symmetry identity d(v·U)/dF = N·v of
     solvers.make_differentiable_solver within 10·gmres_tol; a 3-step
     dynamics.make_differentiable_step trajectory, the gradient of the sum
     of the final heights in F and X0 along two directions against
     central differences; a gradient through K2, K3 or K4 raises;
 50. K2's slab entries (rpy_cuda.pair_sum_slab) at the dense slice's
     10,272 positions split over 4 ranks in this one process: the 1-D
     gather, the ring in the JAX package's order and SUMMA on 2 x 2, at 1
     and 2 RHS, each assembled product against the float64 plain sweep
     (KERNEL_TOL) and the single-device K1/K2 product; the film's box form
     at image_shells 2 and the mixture's POLY form through the ring; ms a
     slab launch (the ring's, the gather's, one rank's) against the plain
     float32 slab and the bound;
 51. K3's row-tile slice (farfield_cuda.near_sweep with t0, nt) at the
     far-field slice's 102,480 blobs, the tiles padded for 1, 2 and 4
     ranks as the distributed context pads them: every slice at 1 and 2
     RHS, the concatenated slices against the float64 plain near sweep
     (KERNEL_TOL) and one whole K3 launch, two launches bitwise equal, the
     slices' listed pairs and the boundary pairs whose fields are
     evaluated twice, ms a slice at 1 and 4 ranks against its bound (a
     boundary pair's in-slice side alone); the POLY form at the
     far-field mixture and the box form at the far-field film's check
     set, over 4 ranks;
 52. the distributed stepper (parallel.make_distributed_step /
     make_distributed_run_bd) on a process group of this one process
     (NCCL, world size 1) at the dense slice and the far-field slice at
     p = 4 and with band 6: deterministic and stochastic steps against
     the single-device step from the same draws (STEP_TOL, GMRES
     iterations ±1, residuals below 10·gmres_tol), the far-field
     operator's first DIST_EXACT_ROWS rows against the exact operator's
     streamed through K2's slab (FF_OPERATOR_TOL), steps/s in turns with
     run_bd, K2 slab / K3 slice launches a step, the step timer's split
     with its collective span; the gather mode
     (parallel.sharded_mobility_apply_fn) through run_bd;
 53. not run: NCCL refuses four ranks on one card (PERF.md); phase 57
     runs D = 4 on the card through gloo ranks instead;
 54. the run driver with a "mesh" key: examples/distributed_suspension.json
     at shape [1], mode "distributed", 10 steps, through python -m
     torch.distributed.run --nproc_per_node 1, then resumed for 10 more:
     the frames and the checkpoint rank 0 wrote, no gap;
 55. K4's slab form (the distributed ring's off-diagonal blocks) at the
     periodic slice's 10,272 positions in L = 14, the ring over 4 ranks
     in this process (ewald.ring_slab): each rank's ring sum at 1 and 2
     RHS within KERNEL_TOL of the float64 Clenshaw sweep, the diagonal
     blocks bitwise K4's symmetric sweep of the block, the n × n slab
     (self pairs masked) against float64, two launches bitwise equal,
     the n × n, n/4 × n and n/4 × n/4 slabs' ms beside their bounds and
     the plain block's;
 56. the balanced split's tile sweep at phase 44's 115,560 blobs in
     L = 30, its sorted tiles padded for 1, 2 and 4 ranks and each rank's
     slice swept in this process through K4 tiles: the slices' union
     bitwise the one-device sweep;
 57. on an NCCL group of this one process, each new distributed path
     against its single-device counterpart from the same draws, with
     steps/s in turns against run_bd / run_bd_multi: the periodic slice
     (classic split and ewald_rc 3.5 with the dense wave part, both
     bitwise), the
     settled slice with distributed RAS (fewer GMRES iterations than
     block_free), the mixture through the POLY ring, the far-field
     mixture and the far-field film (bitwise), each distributed step's
     split under the step timer, make_ensemble_run_bd on a (1, 1) mesh
     with 2 walkers (each walker bitwise the distributed run
     from the same draws); then the periodic slice at D = 4 on the one
     card (4 gloo ranks, the ring's blocks staged through the host): the
     distributed step against the single-device step from every rank's
     draws, K4's slab launches a step, steps/s;
 58. the run driver with a mixture config (the polydisperse film) and
     mesh shape [1] (the gather mesh) through python -m
     torch.distributed.run, then resumed: frames without a gap;
 59. K4 tiles (ewald_cuda.tile_pair_sum) against its plain twin
     (ewald_cells._cell_sweep, KERNEL_TOL) and against the float64
     all-pairs sweep with the cut on the kernel's own folded float32
     inputs (TILES_F64_TOL; beside it the same sweep on the unfolded
     positions), 1 and 2 RHS: at phase 42's positions, at phase 43's
     102,400 points (rc 3.5 and 4.5; 256 sampled rows against float64),
     at phase 44's 115,560 blobs (sampled rows) and in the POLY form at
     phase 45's mixture; bitwise repeats; the row-tile slices at D = 1, 2
     and 4 whose union is bitwise the whole launch (mono at 2 RHS, POLY at
     1); a list one slot narrower than the widest NaN-poisons the apply;
     each case's kernel ms (the launch over a built work list) beside
     its bound (kept unordered pairs counted on this run's data), the
     work list's ms and the wrapper's (list and launch), the twin's ms,
     the partials' scratch bytes, and the share of the kernel's executed
     warp steps (8 × 8 sub-blocks with a kept pair) that carry a kept
     pair, beside the share K1's and K3's column rotation would have.

Phases 1-5 drive the dense path (K1/K2), phases 6-9 the far-field path
(K3), phases 10-14 the triply-periodic path (K4), phases 17-19 the settled
path (K1/K2 under the RAS preconditioner), phases 21-23 the film path
(K1/K2 in the box), phases 24-26 the far-field film path (K3's box form),
phases 27-31 the mixture path (K1/K2's POLY forms, multi.run_bd_multi),
phases 32-35 the far-field mixture path (K3's POLY form, the radius-split
lattices, multi.run_bd_multi on the far field), phases 36-38 the
polydisperse film path (K1/K2's POLY × BOX forms through the run driver),
phase 39 the exact-drift and unpreconditioned stepper modes, phases
40-41 the RigidBody API over the dense (K1/K2) and far-field (K3) paths,
phases 42-45 the balanced-split periodic path (the tile sweep through
K4 tiles and the gridded wave part; K4 as the classic split's
yardstick),
phases 46-48 the far field's band tier (K3 and the band's matmuls),
phase 49 the adjoints (K1 under autograd), phases 50-54 the
distributed path (K2's slab entries, K3's row-tile slice, the
distributed stepper and driver), phases 55-58 the rest of it (K4's slab
form, the tile sweep's slices, distributed RAS, the distributed mixture,
the film's far field over a group, the ensemble runner, the mixture on
the gather mesh), phase 59 K4 tiles at the balanced split's shapes;
phase 15 is the probe's own entry point.  The kernels
are built at first use from the checkout's sources, one nvcc per source,
all started together.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it holds the per-kernel JSON summary.  Without a CUDA
device the script exits nonzero and prints no result.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_BODIES = 16
SHELL = "shell_N_642"
WARM_STEPS = 1
TIMED_STEPS = 8
SEED = 0
# float32 kernel vs the float64 plain sweep, max|ΔU| / max|U|: the bound
# tests/test_pallas.py holds the TPU kernel to against a float64 oracle
KERNEL_TOL = 5e-6
# kernel step vs plain step, max|ΔX_k − ΔX_p| / max|ΔX_p|: the float32 step
# bound of tests/test_torch_step_f32.py (two float32 solves stopped at
# gmres_tol, plus the RFD drift's 1/rfd_delta = 1e4 amplification of
# float32 roundoff)
STEP_TOL = 2e-3
SOURCE = "rigid_body_light_tpu_torch/csrc/rpy_pair_sweep.cu"
K3_SOURCE = "rigid_body_light_tpu_torch/csrc/near_sweep.cu"
# the at-scale far-field slice, bench.py::seg_farfield102k
FF_BODIES = 40
FF_CHECK_BODIES = 10      # phases 6 and 9: 25,620 blobs
FF_SHELL = "shell_N_2562"
FF_GRID = (12, 12, 3)
FF_P = 4
FF_WARM_STEPS = 1
FF_TIMED_STEPS = 2
# far field (p = 4) against the exact operator, max|ΔU| / max|U|: the JAX
# config's operator-error estimate for p = 4 is ~5e-3
FF_OPERATOR_TOL = 1e-2
# the periodic slice, scripts/tpu_ewald_bench.py
EW_BOX = (14.0, 14.0, 14.0)
EW_TOL = 1e-4
EW_WARM_STEPS = 1
EW_TIMED_STEPS = 8
K4_SOURCE = "rigid_body_light_tpu_torch/csrc/ewald_real_sweep.cu"
P_SOURCE = "rigid_body_light_tpu_torch/csrc/fma_peak.cu"
# float32 operator through K4 against the float64 operator with closed-form
# scalars, max|ΔU| / max|U|: the fit is 3e-6 of scale, ewald_tol is 1e-4
EW_OPERATOR_TOL = 1e-4
# |F₁·M F₂ − F₂·M F₁| / |F₁·M F₂|
EW_SYMMETRY_TOL = 1e-5
# float32 wave part against float64: TF32 matmuls would leave ~1e-3
EW_WAVE_TOL = 2e-5
# P against its plain version in float64, max relative error of a row: the
# chain's 64 roundings of half an ulp average out over a row of random
# inputs; on the probe's own input (ones) every addend of a row sum is the
# same number and rounds alike, so the bound is looser there
P_TOL = 1e-6
P_TOL_ONES = 5e-6
# phase 16: K1 at the JAX package's measured size, checked on sampled rows
SCALE_N = 409_600
SCALE_ROWS = 256
# K4 over tile groups (tile_items.cuh: past 65,536 blobs; 513 tiles in 256
# groups, one of 3), checked on sampled rows
K4_GROUPED_N = 65_664
# the settled slice, bench.py::seg_settled: its checkpoint, 1 warm-up and
# 20 timed steps (its n_set)
SETTLED_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "scripts", "data", "settled_642.npz")
ST_WARM_STEPS = 1
ST_TIMED_STEPS = 20
# phase 17: both preconditioners from one RHS at this tolerance; the two U
# agree to 10× it
ST_SOLVE_TOL = 1e-5
# the JAX package's TPU records of the settled slice, printed beside the
# port's mean iterations as a comparison (the draws differ): 8.0 at
# gmres_tol 3e-4 (bench.py::seg_settled), 9.2 at 1e-4 (BENCH_NOTES.md:140)
TPU_MEAN_ITERS = {"3e-4": 8.0, "1e-4": 9.2}
# phase 20: steps a slice runs under the step timer
SPLIT_STEPS = {"dense": 3, "far-field": 1, "periodic": 3, "settled": 3,
               "film": 3, "far-field film": 1}
# the film slice (examples/periodic_film.json at the dense slice's size):
# the lattice tiles a (10, 10) box exactly
FILM_SPACING = 2.5
FILM_WARM_STEPS = 1
FILM_TIMED_STEPS = 8
FILM_SHELLS = 2
# phase 21: K1's grouped kernel in the box, on sampled rows
FILM_GROUPED_N = 66_000
# the far-field film (phases 24-26): the far-field slice's bodies on an
# 8 × 5 lattice in the (20.8, 13.0) box it tiles, cells of 1.3 × 1.3 in the
# plane, the image sum at 6 shells (≈ 1e-4 with the tail, DESIGN.md §6a)
FB_SIDE = 8
FB_BOX = (20.8, 13.0)
FB_GRID = (16, 10, 3)
FB_SHELLS = 6
# phase 26: 10 bodies on a 5 × 2 lattice in the (13.0, 5.2) box it tiles
FB_CHECK_SIDE = 5
FB_CHECK_BOX = (13.0, 5.2)
FB_CHECK_GRID = (10, 4, 3)
# the mixture slice (phases 27-30), scripts/tpu_mixture_bench.py: 12 big
# and 16 small bodies, the small species' geometry scaled by 0.5 with its
# own blob radius (half its scaled blob spacing, run.py's "blob_radius"),
# the bench's 8 timed steps
MIX_BIG = 12
MIX_SMALL = 16
MIX_SMALL_SHELL = "shell_N_162"
MIX_SCALE = 0.5
MIX_WARM_STEPS = 1
MIX_TIMED_STEPS = 8
MIX_SPLIT_STEPS = 3
# phase 31: tests/test_multi.py's dense wall mixture at this tolerance; the
# two U agree to 10× it
MIX_RAS_TOL = 1e-5
# the far-field mixture (phases 32-35): the far-field slice's 40 ×
# shell_N_2562 and 40 × shell_N_162 scaled by MIX_SCALE at their own blob
# radius in the lattice's gaps; phase 35 at 10 + 10 bodies, open and in the
# far-field film's check box
FM_SPLIT_STEPS = 1
# operations a pair of the POLY fields costs beyond the monodisperse 60,
# counted from rpy_fields.cuh::pair_fields_poly's far branch: aR² + aC²
# (2), aR + aC, aR − aC, (aR² + aC²)/3, and the wall's 1/√(aR·aC) (3), the
# two scaled heights (2) floored per pair (2), the scaled ρ² (2) and
# q = inv_ae/R (1)
POLY_EXTRA_FLOP = 15
# the polydisperse film (phases 36-38): the mixture slice in the film
# slice's (10, 10) box at image_shells 2, through the driver in chunks of 8
# steps (one warm-up chunk, one timed, one resumed), a frame every 4
PF_BOX = (10.0, 10.0)
PF_SHELLS = 2
PF_CHUNK = 8
PF_SAVE_EVERY = 4
# phase 39: timed steps of each stepper mode, and the example configs the
# driver runs for one checkpoint chunk
MODE_TIMED_STEPS = 3
EXAMPLES = ("periodic_film.json", "sedimenting_suspension.json")
# the examples' max_step_residual (the SimulationConfig default): a step
# whose solve ends above it is not committed
EXAMPLE_MAX_RESIDUAL = 1e-2
# phase 40: solve_resistance(solve_mobility(F).U) against F, in units of
# gmres_tol · max|F|: each solve stops at relative residual gmres_tol, the
# two errors add, and the operators' conditioning multiplies them (1.2-1.7
# gmres_tol at 16 × shell_N_162 on the CPU, float32 and float64)
ROUNDTRIP_TOL = 10.0
# the balanced split (phases 42-45): rc and the gridded wave part's nodes a
# cell, and each balanced-split operator's bound against the classic split
# through K4, max|dU| / max|U| (both truncate at ewald_tol 1e-4)
BAL_RC = 3.5
BAL_P = 4
BAL_OPERATOR_TOL = 2e-4
# phase 43: scripts/tpu_ewald_pme_bench.py's case 1 (102,400 uniform points
# in L = 30, a = 0.243553), both cutoffs, and the rows sampled to hold the
# tile sweep against the float64 all-pairs sweep with the same cut
PME_BENCH_N = 102_400
PME_BENCH_L = 30.0
PME_BENCH_A = 0.243553
PME_BENCH_RCS = (3.5, 4.5)
# phase 44: 180 x shell_N_642 on a 6 x 6 x 5 lattice in a cubic L = 30 box
# (spacing 5.0, 5.0, 6.0, offset 0.5 as ewald_setup)
BS_SIDE = (6, 6, 5)
BS_SPACING = (5.0, 5.0, 6.0)
BS_BOX = (30.0, 30.0, 30.0)
BS_WARM_STEPS = 1
BS_TIMED_STEPS = 2
# phase 45: the mixture slice in a cubic L = 14 box with no wall
BM_TIMED_STEPS = 4
# phases 46-48: the far field's band tier.  Phase 46 is
# scripts/tpu_farfield_bench.py's band case (102,400 points, a = 0.243553:
# the slab above the wall and the free cube of side 30); the band must be
# at least 4x tighter than p = 4 there (the ratio of the JAX package's
# tests/test_farfield.py::test_band_tier_tightens_free).  Phases 47-48 run
# at the two-tier estimate's own tolerance, max(2e-4, 3e-4) at p = 4 +
# band 6, which the configuration does not warn about
BAND_BENCH_N = 102_400
BAND_CUBE_L = 30.0
BAND_GAIN = 4.0
BAND_GMRES_TOL = 3e-4
# phase 49: the adjoints at the dense slice.  The Function's r-bar against
# autograd through the plain float32 sweep: the same computation, so a
# float32 roundoff bound; the 3-step trajectory's two directional
# derivatives against central differences, relative to |grad|, at steps
# where float32 and the solves' gmres_tol leave the difference quotient
# ~1e-4 of it (the loss is nearly linear in F; X0's is near the identity)
ADJ_RBAR_TOL = 1e-5
ADJ_STEPS = 3
ADJ_EPS_F = 0.5
ADJ_EPS_X = 1e-2
ADJ_DIR_TOL = 1e-2
# phases 50-54: distribution.  Phases 50-51 split the sweeps over DIST_D
# ranks in this one process (a 2 x 2 SUMMA mesh); phase 52 runs the
# distributed stepper on a process group of this one process, 1 warm-up
# and DIST_TIMED_STEPS timed steps at the dense slice (FF_TIMED_STEPS at
# the far field) in turns with run_bd; phase 54 runs the run driver for
# DRIVER_MESH_STEPS steps and resumes it for as many
DIST_D = 4
BUILD_LOGS = {}  # library → this run's nvcc log (ptxas -v), filled by main
DIST_WARM_STEPS = 1
DIST_TIMED_STEPS = 8
# phase 52: rows of the distributed far-field operator held against the
# exact operator's, streamed through K2's slab (rpy_cuda.mobility_apply_rows)
DIST_EXACT_ROWS = 8192
DRIVER_MESH_STEPS = 10
# phases 55-58: the periodic slice at D = 4 on one card (gloo ranks), the
# timed steps of the slower world-size-1 paths, the ensemble's steps, the
# periodic slice's GMRES tolerance (ewald_setup's)
DIST4_TIMED_STEPS = 2
ENSEMBLE_STEPS = 2
EW_GMRES_TOL = 1e-4
# phase 59: K4 tiles against the float64 all-pairs sweep with the cut on
# the kernel's own float32 inputs, relative to max|U| (the kernel's float32
# Clenshaw and sums; against the unfolded positions the fold's own
# rounding adds to it, and that reading is recorded beside), and the chunk
# of listed tile pairs tile_steps counts at once
TILES_F64_TOL = 2e-6
KEPT_CHUNK = 8192
# the card's published peaks (H100 SXM at 700 W): FP32 outside the tensor
# cores, and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def slice_placements():
    """bench.py::seg_dispersed's bodies: a 4 × 4 lattice, spacing 2.5, at
    heights 2.0-2.4, unrotated."""
    xs = np.array([[2.5 * (i % 4), 2.5 * (i // 4), 2.0 + 0.2 * (i % 3)]
                   for i in range(N_BODIES)])
    return xs, np.tile([1.0, 0, 0, 0], (N_BODIES, 1))


def slice_setup(torch, device):
    """bench.py::seg_dispersed: 16 × shell_N_642 on a 4 × 4 lattice at
    heights 2.0-2.4, force −ẑ on every body, its _base_cfg settings."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    params, ref = rt.load_structure(SHELL)
    xs, qs = slice_placements()
    cfg = rt.SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=1.0, wall=True,
        dtype=torch.float32, lanczos_iters=6, lanczos_precond=True,
        gmres_tol=1e-4, gmres_restart=20, gmres_maxiter=60,
        matvec_row_tile=512, pc_mode="block_free")
    geom = kin.make_ref_geometry(ref, dtype=torch.float32, device=device)
    state = rt.make_state(xs, qs, dtype=torch.float32, device=device)
    force = torch.zeros((N_BODIES, 6), dtype=torch.float32, device=device)
    force[:, 2] = -1.0
    return cfg, geom, state, force


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(torch, name, apply_kernel, apply_plain, clouds, a, eta):
    """Kernel (float32) against the plain sweep (float64), wall and free,
    on each cloud.  Returns the max absolute error at the first cloud's
    wall case (the main path's shape)."""
    main_err = None
    for label, r, F in clouds:
        for wall in (True, False):
            U = apply_kernel(F.float(), r.float(), a, eta, wall)
            torch.cuda.synchronize()
            ref = apply_plain(F.double(), r.double(), a, eta, wall)
            err = (U.double() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            print(f"{name} {label} n={r.shape[0]} wall={wall}: max|dU|={err:.3e} "
                  f"max|dU|/max|U|={rel:.3e} (tol {KERNEL_TOL:g})")
            if not (rel <= KERNEL_TOL and torch.isfinite(U).all()):
                raise AssertionError(f"{name} disagrees with the plain "
                                     f"sweep on {label}, wall={wall}: {rel}")
            if main_err is None:
                main_err = err
    return main_err


def bound_ms(flops, n_bytes):
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate.  Returns
    (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def farfield_placements(n_bodies, side=None):
    """bench.py::seg_farfield102k's bodies: a lattice ``side`` wide
    (default ⌈√B⌉), spacing 2.6, at heights 2.0-2.4, unrotated."""
    side = side or int(np.ceil(np.sqrt(n_bodies)))
    xs = np.array([[2.6 * (i % side), 2.6 * (i // side), 2.0 + 0.2 * (i % 3)]
                   for i in range(n_bodies)])
    return xs, np.tile([1.0, 0, 0, 0], (n_bodies, 1))


def farfield_setup(torch, device, n_bodies, side=None, box=None,
                   grid=FF_GRID):
    """bench.py::seg_farfield102k: n_bodies × shell_N_2562 on a lattice
    ``side`` wide (default ⌈√B⌉), spacing 2.6, heights 2.0-2.4, force −ẑ
    on every body; its _base_cfg with dt 0.005, GMRES restart 30 / maxiter
    90, p = 4, on ``grid``.  Its gmres_tol 1e-4 lies below the p = 4
    operator error, so the config warns: the solve converges to the
    approximate operator.  box: the pseudo-2D film's (Lx, Ly), which the
    lattice tiles, with image_shells FB_SHELLS."""
    import warnings

    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    params, ref = rt.load_structure(FF_SHELL)
    xs, qs = farfield_placements(n_bodies, side)
    film = {} if box is None else dict(box=box, image_shells=FB_SHELLS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg = rt.SimulationConfig(
            a=params["sep"] / 2, dt=0.005, kBT=1.0, wall=True,
            dtype=torch.float32, lanczos_iters=6, lanczos_precond=True,
            gmres_tol=1e-4, gmres_restart=30, gmres_maxiter=90,
            matvec_row_tile=512, pc_mode="block_free",
            farfield_grid=grid, farfield_p=FF_P, **film)
    geom = kin.make_ref_geometry(ref, dtype=torch.float32, device=device)
    state = rt.make_state(xs, qs, dtype=torch.float32, device=device)
    force = torch.zeros((n_bodies, 6), dtype=torch.float32, device=device)
    force[:, 2] = -1.0
    return cfg, geom, state, force


def ewald_setup(torch, device):
    """scripts/tpu_ewald_bench.py's BD workload: 16 × shell_N_642 on a
    4 × 4 lattice, spacing 3.2, heights 3.0 / 5.5 / 8.0, in a cubic L = 14
    box; no wall, no force; ewald_tol 1e-4, GMRES restart 60."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    params, ref = rt.load_structure(SHELL)
    xs = np.array([[3.2 * (i % 4) + 0.5, 3.2 * (i // 4) + 0.5,
                    3.0 + 2.5 * (i % 3)] for i in range(N_BODIES)])
    qs = np.tile([1.0, 0, 0, 0], (N_BODIES, 1))
    cfg = rt.SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=1.0, box=EW_BOX, wall=False,
        dtype=torch.float32, lanczos_iters=6, gmres_tol=1e-4,
        gmres_restart=60, gmres_maxiter=60, pc_mode="block_free",
        ewald_tol=EW_TOL)
    geom = kin.make_ref_geometry(ref, dtype=torch.float32, device=device)
    state = rt.make_state(xs, qs, dtype=torch.float32, device=device)
    return cfg, geom, state


def settled_setup(torch, device):
    """bench.py::seg_settled: the checkpoint scripts/data/settled_642.npz
    (16 × shell_N_642 = 10,272 blobs settled above a wall, read by path),
    float32, dt 0.01, kBT 1, gmres_tol 3e-4, restart 60, maxiter 60, the
    RAS preconditioner (halo 8a, at most 64 blobs), adaptive Lanczos (6 to
    14 iterations, err_tol 1e-3), gravity −ẑ and wall repulsion (strength
    4, Debye length 0.3, radius 1)."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch import forces
    from rigid_body_light_tpu_torch.ops import kinematics as kin
    from rigid_body_light_tpu_torch.utils import checkpoint

    params, ref = rt.load_structure(SHELL)
    cfg = rt.SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=1.0, wall=True,
        dtype=torch.float32, lanczos_iters=6, lanczos_precond=True,
        gmres_tol=3e-4, gmres_restart=60, gmres_maxiter=60,
        matvec_row_tile=512, pc_mode="ras", pc_halo=8.0, pc_halo_max=64,
        lanczos_max_iters=14, lanczos_err_tol=1e-3)
    geom = kin.make_ref_geometry(ref, dtype=torch.float32, device=device)
    state, _, _, _ = checkpoint.load_checkpoint(
        SETTLED_CKPT, dtype=torch.float32, device=device)
    force_fn = forces.sum_forces(
        forces.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        forces.wall_repulsion(strength=4.0, debye_length=0.3, radius=1.0))
    return cfg, geom, state, force_fn


def film_setup(torch, device, shells):
    """The pseudo-2D film: 16 × shell_N_642 on the dense slice's 4 × 4
    lattice (spacing 2.5, heights 2.0-2.4) in the (10, 10) box it tiles
    exactly, above the wall; examples/periodic_film.json's
    physics and solver: dt 0.01, kBT 0.3, float32, gravity −ẑ, wall
    repulsion (4, 0.3), Yukawa pairs (1, 0.5, diameter 2) in the box,
    GMRES tol 1e-4 / restart 20 / maxiter 60, 8 preconditioned Lanczos
    iterations, block_free."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch import forces
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    params, ref = rt.load_structure(SHELL)
    side = int(round(N_BODIES ** 0.5))
    box = (FILM_SPACING * side, FILM_SPACING * side)
    xs = np.array([[FILM_SPACING * (i % side), FILM_SPACING * (i // side),
                    2.0 + 0.2 * (i % 3)] for i in range(N_BODIES)])
    qs = np.tile([1.0, 0, 0, 0], (N_BODIES, 1))
    cfg = rt.SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=0.3, wall=True, box=box,
        image_shells=shells, dtype=torch.float32, lanczos_iters=8,
        lanczos_precond=True, gmres_tol=1e-4, gmres_restart=20,
        gmres_maxiter=60, matvec_row_tile=512, pc_mode="block_free")
    geom = kin.make_ref_geometry(ref, dtype=torch.float32, device=device)
    state = rt.make_state(xs, qs, dtype=torch.float32, device=device)
    force_fn = forces.sum_forces(
        forces.gravity(np.array([0, 0, -1.0, 0, 0, 0])),
        forces.wall_repulsion(strength=4.0, debye_length=0.3),
        forces.pair_yukawa(1.0, 0.5, diameter=2.0, box=box))
    return cfg, geom, state, force_fn


def mixture_setup(torch, device, poly=True):
    """scripts/tpu_mixture_bench.py's mixture: 12 × shell_N_642 at
    (2.5·(i%4), 2.5·(i//4), 2.0 + 0.2·(i%3)), force −ẑ, and 16 ×
    shell_N_162 at (1.25 + 2.5·(i%4), 1.25 + 2.5·(i//4), 3.6 + 0.2·(i%3)),
    force −scale³·ẑ, identity quaternions, above the wall; a = sep_642/2,
    float32, dt 0.01, kBT 1, 8 preconditioned Lanczos iterations, GMRES
    tol 1e-4 / restart 20 / maxiter 60, block_free.  poly: the small species
    scaled by 0.5 with its own blob radius, half its scaled blob spacing
    (run.py's per-species "blob_radius"); else scaled by sep_642/sep_162 at
    blob radius a (the bench's own, monodisperse).  Returns (cfg, mgeom,
    states, forces)."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch import multi

    p642, ref642 = rt.load_structure(SHELL)
    p162, ref162 = rt.load_structure(MIX_SMALL_SHELL)
    if poly:
        scale, radii = MIX_SCALE, [None, MIX_SCALE * p162["sep"] / 2]
    else:
        scale, radii = p642["sep"] / p162["sep"], None
    cfg = rt.SimulationConfig(
        a=p642["sep"] / 2, dt=0.01, kBT=1.0, wall=True,
        dtype=torch.float32, lanczos_iters=8, lanczos_precond=True,
        gmres_tol=1e-4, gmres_restart=20, gmres_maxiter=60,
        matvec_row_tile=512, pc_mode="block_free")
    mgeom = multi.MultiGeometry.create([ref642, scale * ref162],
                                       dtype=torch.float32, radii=radii,
                                       device=device)
    xb = np.array([[2.5 * (i % 4), 2.5 * (i // 4), 2.0 + 0.2 * (i % 3)]
                   for i in range(MIX_BIG)])
    xs = np.array([[1.25 + 2.5 * (i % 4), 1.25 + 2.5 * (i // 4),
                    3.6 + 0.2 * (i % 3)] for i in range(MIX_SMALL)])
    states = tuple(rt.make_state(x, np.tile([1.0, 0, 0, 0], (len(x), 1)),
                                 dtype=torch.float32, device=device)
                   for x in (xb, xs))
    forces = []
    for b, f in ((MIX_BIG, -1.0), (MIX_SMALL, -scale ** 3)):
        F = torch.zeros((b, 6), dtype=torch.float32, device=device)
        F[:, 2] = f
        forces.append(F)
    return cfg, mgeom, states, tuple(forces)


def farfield_mixture_setup(torch, device, n_bodies, side=None, box=None,
                           grid=FF_GRID):
    """The far-field mixture: farfield_setup's n_bodies × shell_N_2562 (blob
    radius a = sep_2562/2, force −ẑ) on its lattice ``side`` wide, and
    n_bodies × shell_N_162 scaled by MIX_SCALE at its own blob radius
    MIX_SCALE·sep_162/2 (run.py's per-species "blob_radius"; force
    −MIX_SCALE³·ẑ) in the lattice's gaps at (1.3 + 2.6·(i%side), 1.3 +
    2.6·(i//side), 3.6 + 0.2·(i%3)), identity quaternions; the far-field
    slice's solver settings on ``grid`` (box: the film's, image_shells
    FB_SHELLS).  Returns (cfg, mgeom, states, forces)."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch import multi

    cfg, _, state, force = farfield_setup(torch, device, n_bodies,
                                          side=side, box=box, grid=grid)
    side = side or int(np.ceil(np.sqrt(n_bodies)))
    _, ref2562 = rt.load_structure(FF_SHELL)
    p162, ref162 = rt.load_structure(MIX_SMALL_SHELL)
    mgeom = multi.MultiGeometry.create(
        [ref2562, MIX_SCALE * ref162], dtype=torch.float32,
        radii=[None, MIX_SCALE * p162["sep"] / 2], device=device)
    xs = np.array([[1.3 + 2.6 * (i % side), 1.3 + 2.6 * (i // side),
                    3.6 + 0.2 * (i % 3)] for i in range(n_bodies)])
    small = rt.make_state(xs, np.tile([1.0, 0, 0, 0], (n_bodies, 1)),
                          dtype=torch.float32, device=device)
    f_small = torch.zeros((n_bodies, 6), dtype=torch.float32, device=device)
    f_small[:, 2] = -MIX_SCALE ** 3
    return cfg, mgeom, (state, small), (force, f_small)


def check_near_forms(torch, farfield, farfield_cuda, label, ctx, rng,
                     walls=(True, False), box=None, wrap=None, poly=True):
    """K3's box, POLY or POLY × BOX form (float32; poly: the radii of
    ctx.ah_s) against the plain near sweep in float64 on the same float32
    inputs (and float32 box, so both take the same image of every pair),
    1 and 2 RHS, live rows; two launches bitwise equal.  Returns {(wall,
    k): max abs err}."""
    live = ctx.id_s >= 0
    x32 = ctx.x_s.float().contiguous()
    a32 = ctx.ah_s.float().contiguous() if poly else None
    form = " x ".join((["POLY"] if poly else []) + (["BOX"] if box else []))
    F = torch.from_numpy(rng.standard_normal(
        (2, ctx.x_s.shape[0], 3))).to(ctx.x_s.device).float()
    errs = {}
    for wall in walls:
        # the sweep is linear in F, each RHS apart: 2 RHS is both references
        ref = farfield._near_sweep(
            x32.double(), ctx.ci_s, ctx.id_s, F.double(), ctx.nbr, wall, 0.75,
            box_n=box, wrap_xy=wrap,
            ah_s=a32.double() if poly else None)[:, live]
        for k in (1, 2):
            args = (x32, ctx.ci_s, live, F[:k].contiguous(), ctx.nbr,
                    ctx.pairs, ctx.n_pairs, wall, 0.75, box, wrap, a32)
            U = farfield_cuda.near_sweep_kernel(*args)
            torch.cuda.synchronize()
            err = (U[:, live].double() - ref[:k]).abs().max().item()
            rel = err / ref[:k].abs().max().item()
            same = torch.equal(U, farfield_cuda.near_sweep_kernel(*args))
            del U
            print(f"K3 {form} form {label} n={int(live.sum())} box={box} "
                  f"cells={wrap} wall={wall} k={k}: max|dU|={err:.3e} "
                  f"max|dU|/max|U|={rel:.3e} (tol {KERNEL_TOL:g}); two "
                  f"launches bitwise equal: {same}")
            if not (rel <= KERNEL_TOL and same):
                raise AssertionError(f"K3's {form} form disagrees with the "
                                     f"plain sweep on {label}, wall={wall}, "
                                     f"k={k}: {rel}, {same}")
            errs[wall, k] = err
        del ref
    return errs


def k3_poly_times(torch, farfield, farfield_cuda, label, ctx, rng,
                  box=None, wrap=None):
    """K3's POLY form against its monodisperse form at the same positions,
    in turns (mono, poly, poly, mono), wall, 1 and 2 RHS; the plain float32
    sweep with radii; the bound over this data's kept pairs.  Returns {k:
    dict}."""
    live = ctx.id_s >= 0
    x32, a32 = ctx.x_s.float().contiguous(), ctx.ah_s.float().contiguous()
    n_pad, (t, w) = ctx.x_s.shape[0], ctx.nbr.shape
    pairs = near_pairs(torch, ctx, farfield.TILE, wrap_cells=wrap)
    F = torch.from_numpy(rng.standard_normal((2, n_pad, 3))).to(
        ctx.x_s.device).float()
    out = {}
    for k in (1, 2):
        Fk = F[:k].contiguous()
        args = (x32, ctx.ci_s, live, Fk, ctx.nbr, ctx.pairs, ctx.n_pairs,
                True, 0.75, box, wrap)
        turns = {"mono": [], "poly": []}
        for form in ("mono", "poly", "poly", "mono"):
            turns[form].append(cuda_ms(
                torch, lambda: farfield_cuda.near_sweep_kernel(
                    *args, a32 if form == "poly" else None), 20))
        plain = cuda_ms(torch, lambda: farfield._near_sweep(
            x32, ctx.ci_s, ctx.id_s, Fk, ctx.nbr, True, 0.75, box_n=box,
            wrap_xy=wrap, ah_s=a32), 1)
        flops = pairs // 2 * (60 + POLY_EXTRA_FLOP + 60 * k)
        b = bound_ms(flops, n_pad * (12 + 12 + 1 + 4 + 24 * k) + 4 * t * w)
        b_mono = bound_ms(pairs // 2 * (60 + 60 * k),
                          n_pad * (12 + 12 + 1 + 24 * k) + 4 * t * w)
        v = dict(ms=min(turns["poly"]), ms_mono=min(turns["mono"]),
                 turns=turns, plain_ms=plain, bound=b, bound_mono=b_mono,
                 pairs=pairs)
        out[k] = v
        print(f"K3 POLY{' x BOX' if box else ''} form time at {label} "
              f"n={int(live.sum())} (n_pad {n_pad}, {t} tiles, "
              f"{int(ctx.n_pairs.item())} tile pairs, {pairs} kept ordered "
              f"pairs), wall, {k} RHS: {v['ms']:.4f} ms (turns mono/poly "
              f"{turns['mono']} / {turns['poly']}), "
              f"{v['ms'] / v['ms_mono']:.3f}x its monodisperse form at the "
              f"same positions; plain float32 {plain:.4f} ms; bound "
              f"{b[0]:.4f} ms ({b[1]}), {v['ms'] / b[0]:.2f}x (the mono form "
              f"{v['ms_mono'] / b_mono[0]:.2f}x its {b_mono[0]:.4f} ms)")
    return out


def mixture_step_check(torch, multi, label, cfg, mgeom, states, forces,
                       gen, counters):
    """One mixture step through the kernels against one through the plain
    float32 sweep, from identical draws; the launch counts of the kernel
    step.  Returns (max|ΔX_k − ΔX_p| / max|ΔX_p|, launch counts)."""
    draws = multi.make_draws_multi(mgeom, states, gen)
    reset_launches(counters)
    sk, aux_k = multi.stochastic_step_multi(mgeom, cfg, states, forces,
                                            draws=draws)
    torch.cuda.synchronize()
    counts = {}
    for mod in counters:
        counts.update(mod.launch_counts())
    sp, aux_p = multi.stochastic_step_multi(
        mgeom, cfg.replace(use_pallas=False), states, forces, draws=draws)
    torch.cuda.synchronize()
    dX_k = torch.cat([a_.X - b_.X for a_, b_ in zip(sk, states)])
    dX_p = torch.cat([a_.X - b_.X for a_, b_ in zip(sp, states)])
    rel = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    n = sum(g.n_blobs * s_.X.shape[0] for g, s_ in zip(mgeom.geoms, states))
    print(f"mixture step {label} kernels vs plain at n={n}: "
          f"max|dX_k - dX_p|/max|dX_p| = {rel:.3e} (tol {STEP_TOL:g}); iters "
          f"{aux_k.iters} vs {aux_p.iters}; residual "
          f"{aux_k.residual.item():.3e} vs {aux_p.residual.item():.3e}; "
          f"launches of the kernel step {counts}")
    if not (rel <= STEP_TOL and torch.isfinite(dX_k).all()):
        raise AssertionError(f"the mixture step ({label}) through the "
                             f"kernels disagrees with the plain step: {rel}")
    return rel, counts


def check_poly_sweeps(torch, rpy, rpy_cuda, label, r32, ahat32, F32, h):
    """K1's and K2's POLY forms against the float64 plain sweep with radii
    on the same float32 inputs, wall and free, 1 and 2 RHS (K1 at 2 RHS on
    its pair terms).  Returns {(kernel, wall, k): max abs err}; raises after
    printing if one is out of bounds."""
    n = r32.shape[0]
    ids = torch.arange(n, device=r32.device)
    errs, bad = {}, []
    for wall in (True, False):
        ref = rpy.pair_sum(r32.double(), ids, r32.double(), ids, F32.double(),
                           wall=wall, row_tile=256, h_floor=h,
                           radii_rows=ahat32.double(),
                           radii_cols=ahat32.double())
        for k in (1, 2):
            Fk = F32[:k].contiguous()
            scale = ref[:k].abs().max().item()
            for name in ("K1", "K2"):
                if name == "K1":
                    U = rpy_cuda.pair_sweep_sym(r32, Fk, wall, h, ahat=ahat32)
                else:
                    U = rpy_cuda.pair_sweep_ordered(r32, 0, r32, Fk, 0, wall,
                                                    h, ahat_rows=ahat32,
                                                    ahat_cols=ahat32)
                torch.cuda.synchronize()
                err = (U.double() - ref[:k]).abs().max().item()
                errs[name, wall, k] = err
                print(f"{name} POLY form {label} n={n} wall={wall} k={k}: "
                      f"max|dU|={err:.3e} max|dU|/max|U|={err / scale:.3e} "
                      f"(tol {KERNEL_TOL:g})")
                if not (err <= KERNEL_TOL * scale
                        and bool(torch.isfinite(U).all())):
                    bad.append((name, wall, k, err / scale))
        del ref
    if bad:
        raise AssertionError(f"the POLY forms disagree with the plain sweep "
                             f"on {label}: {bad}")
    return errs


def poly_pair_clouds(rng, a_small=0.6, a_big=1.1):
    """Two clouds in units of a with radii from {a_small, a_big}: a ragged
    1,000-blob cloud whose heights straddle the wall-height floor (0.3a to
    8a), and 300 blobs in 150 close pairs of unequal radii at distances
    0.01-1.6 (the deep branch below |aᵢ − aⱼ| = 0.5, the overlap branch up
    to aᵢ + aⱼ = 1.7).  Returns [(label, r, ahat)]."""
    ragged = rng.uniform([-12, -12, 0.3], [12, 12, 8], (1000, 3))
    rag_a = rng.choice([a_small, a_big], 1000)
    base = rng.uniform([-6, -6, 0.3], [6, 6, 4], (150, 3))
    dirs = rng.standard_normal((150, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dist = np.geomspace(0.01, 1.6, 150)
    pairs = np.stack([base, base + dist[:, None] * dirs], axis=1)
    pair_a = np.tile([a_small, a_big], (150, 1))
    return [("ragged", ragged, rag_a),
            ("close pairs", pairs.reshape(-1, 3), pair_a.reshape(-1))]


def check_box_sweeps(torch, rpy, rpy_cuda, label, r32, F32, box, h,
                     kernels=("K1", "K2"), rows=None):
    """K1 (with the self-image diagonal) and K2 in the box against the
    float64 plain sweep on the same float32 inputs (so both take the same
    image of every pair, the seams included), wall, image_shells 0 and
    FILM_SHELLS, 1 and 2 RHS, on every row or the sampled ``rows``; the
    plain float32 sweep's error beside.  Returns {(kernel, S, k): max
    abs err}; raises after printing if one is out of bounds."""
    n = r32.shape[0]
    ids = torch.arange(n, device=r32.device)
    rows = ids if rows is None else rows
    errs, bad = {}, []
    for S in (0, FILM_SHELLS):
        args = rpy_cuda.box_args(box, S)
        for k in (1, 2):
            Fk = F32[:k].contiguous()
            ref = rpy.pair_sum(r32[rows].double(), rows, r32.double(), ids,
                               Fk.double(), wall=True, row_tile=64,
                               h_floor=h, box=box, image_shells=S)
            scale = ref.abs().max().item()
            plain = rpy.pair_sum(r32[rows], rows, r32, ids, Fk, wall=True,
                                 row_tile=64, h_floor=h, box=box,
                                 image_shells=S)
            rel_plain = (plain.double() - ref).abs().max().item() / scale
            del plain
            for name in kernels:
                if name == "K1":
                    U = rpy_cuda.pair_sweep_sym(r32, Fk, True, h, box=args)
                    if S:
                        U = U + rpy.self_image_sum(r32, Fk, True, box, S,
                                                   h_floor=h)
                else:
                    U = rpy_cuda.pair_sweep_ordered(r32, 0, r32, Fk, 0, True,
                                                    h, box=args)
                torch.cuda.synchronize()
                U = U[:, rows]
                err = (U.double() - ref).abs().max().item()
                errs[name, S, k] = err
                print(f"{name} box form {label} n={n} box={box} "
                      f"image_shells={S} k={k}: max|dU|={err:.3e} "
                      f"max|dU|/max|U|={err / scale:.3e} (tol {KERNEL_TOL:g});"
                      f" the plain float32 sweep {rel_plain:.3e}")
                if not (err <= KERNEL_TOL * scale
                        and bool(torch.isfinite(U).all())):
                    bad.append((name, S, k, err / scale))
    if bad:
        raise AssertionError(f"the box forms disagree with the plain sweep "
                             f"on {label}: {bad}")
    return errs


def box_entries(film_k, film, name, key):
    """A kernel's box-form keys of the summary line: per image_shells S its
    time, plain time, bound and max abs error at the film slice, and its
    launches on the film slice's run."""
    out = {}
    for (nm, S), v in film_k.items():
        if nm == name:
            out.update({f"ms_box_s{S}": v["ms"],
                        f"plain_ms_box_s{S}": v["plain_ms"],
                        f"bound_ms_box_s{S}": v["bound"][0],
                        f"max_abs_err_box_s{S}": v["err"],
                        f"launches_film_s{S}": film[S][key]})
    return out


def poly_entries(poly_t, name, launches):
    """A kernel's POLY-form keys of the summary line, at the mixture slice:
    its times at 1 and 2 RHS, its monodisperse form's at the same
    positions, the plain float32 sweep's, the bounds, the max abs errors
    against float64 (wall), and its launches on the mixture slice's run."""
    out = {"launches_mixture": launches}
    for k, tag in ((1, ""), (2, "_2rhs")):
        v = poly_t[name, k]
        out.update({f"ms{tag}_poly": v["ms"], f"ms{tag}_mono_at_mixture":
                    v["ms_mono"], f"plain_ms{tag}_poly": v["plain_ms"],
                    f"bound_ms{tag}_poly": v["bound"][0],
                    f"max_abs_err{tag}_poly": v["err"]})
    return out


def k3_poly_entries(k3p, errs, k3pb, errs_box, ff_mix):
    """K3's POLY keys of the summary line: at the far-field mixture slice
    (POLY) and its film check set (POLY × BOX), 1 and 2 RHS, its time, its
    monodisperse form's at the same positions, the plain float32 sweep's,
    the bound and the ratio, the max abs error against float64 (wall); its
    launches on the slice's run and on the film check step."""
    out = {"poly_form_in": 10, "launches_farfield_mixture": ff_mix["k3_poly"],
           "launches_film_mixture_step": ff_mix["k3_poly_box_film_step"]}
    for tag, times, err in (("poly", k3p, errs), ("poly_box", k3pb,
                                                  errs_box)):
        for k, rhs in ((1, ""), (2, "_2rhs")):
            v = times[k]
            out.update({f"ms{rhs}_{tag}": v["ms"],
                        f"ms{rhs}_mono_at_{tag}": v["ms_mono"],
                        f"plain_ms{rhs}_{tag}": v["plain_ms"],
                        f"bound_ms{rhs}_{tag}": v["bound"][0],
                        f"bound_ratio{rhs}_{tag}": v["ms"] / v["bound"][0],
                        f"max_abs_err{rhs}_{tag}": err[True, k]})
    return out


def check_poly_box_sweeps(torch, rpy, rpy_cuda, label, r32, ahat32, F32, box,
                          h, walls=(True, False)):
    """K1's (with the self images at each blob's radius) and K2's POLY × BOX
    forms against the float64 plain sweep with radii, box and images on the
    same float32 inputs and box, wall and free, image_shells 0 and
    PF_SHELLS, 1 and 2 RHS; two launches bitwise equal.  Returns {(kernel,
    wall, S, k): max abs err}; raises after printing if one is out of
    bounds."""
    n = r32.shape[0]
    ids = torch.arange(n, device=r32.device)
    errs, bad = {}, []
    for wall in walls:
        for S in (0, PF_SHELLS):
            args = rpy_cuda.box_args(box, S)
            ref = rpy.pair_sum(r32.double(), ids, r32.double(), ids,
                               F32.double(), wall=wall, row_tile=256,
                               h_floor=h, box=box, image_shells=S,
                               radii_rows=ahat32.double(),
                               radii_cols=ahat32.double())
            for k in (1, 2):
                Fk = F32[:k].contiguous()
                scale = ref[:k].abs().max().item()
                for name in ("K1", "K2"):
                    def launch():
                        if name == "K1":
                            return rpy_cuda.pair_sweep_sym(
                                r32, Fk, wall, h, box=args, ahat=ahat32)
                        return rpy_cuda.pair_sweep_ordered(
                            r32, 0, r32, Fk, 0, wall, h, box=args,
                            ahat_rows=ahat32, ahat_cols=ahat32)
                    U, U2 = launch(), launch()
                    torch.cuda.synchronize()
                    same = torch.equal(U, U2)
                    if name == "K1" and S:
                        U = U.double() + rpy.self_image_sum(
                            r32.double(), Fk.double(), wall, box, S,
                            h_floor=h, ahat=ahat32.double())
                    err = (U.double() - ref[:k]).abs().max().item()
                    errs[name, wall, S, k] = err
                    print(f"{name} POLY x BOX form {label} n={n} box={box} "
                          f"wall={wall} image_shells={S} k={k}: max|dU|="
                          f"{err:.3e} max|dU|/max|U|={err / scale:.3e} (tol "
                          f"{KERNEL_TOL:g}); two launches bitwise equal: "
                          f"{same}")
                    if not (err <= KERNEL_TOL * scale and same
                            and bool(torch.isfinite(U).all())):
                        bad.append((name, wall, S, k, err / scale, same))
            del ref
    if bad:
        raise AssertionError(f"the POLY x BOX forms disagree with the plain "
                             f"sweep or with themselves on {label}: {bad}")
    return errs


def poly_film_config(out_dir, n_steps, checkpoint_every, save_every):
    """The polydisperse film through the driver: mixture_setup's bodies,
    forces and solver (scripts/tpu_mixture_bench.py's mixture, the small
    species at its own "blob_radius") from "file" placements, in the film
    slice's (10, 10) box above the wall at image_shells PF_SHELLS.  Writes
    the placements beside the config; returns (config path, config)."""
    import rigid_body_light_tpu_torch as rt

    p642, _ = rt.load_structure(SHELL)
    p162, _ = rt.load_structure(MIX_SMALL_SHELL)
    xb = np.array([[2.5 * (i % 4), 2.5 * (i // 4), 2.0 + 0.2 * (i % 3)]
                   for i in range(MIX_BIG)])
    xs = np.array([[1.25 + 2.5 * (i % 4), 1.25 + 2.5 * (i // 4),
                    3.6 + 0.2 * (i % 3)] for i in range(MIX_SMALL)])
    species = []
    for name, X, struct, extra, fz in (
            ("big", xb, SHELL, {}, -1.0),
            ("small", xs, MIX_SMALL_SHELL,
             {"scale": MIX_SCALE, "blob_radius": MIX_SCALE * p162["sep"] / 2},
             -MIX_SCALE ** 3)):
        path = os.path.join(out_dir, f"{name}.npz")
        np.savez(path, X=X, Q=np.tile([1.0, 0, 0, 0], (len(X), 1)))
        species.append({"structure": struct, "n_bodies": len(X),
                        "placement": {"type": "file", "path": path},
                        "forces": [{"type": "gravity",
                                    "value": [0, 0, fz, 0, 0, 0]}], **extra})
    conf = {"species": species, "a": p642["sep"] / 2, "eta": 1.0,
            "dt": 0.01, "kBT": 1.0, "wall": True, "box": list(PF_BOX),
            "dtype": "float32", "n_steps": n_steps,
            "save_every": save_every, "checkpoint_every": checkpoint_every,
            "seed": SEED, "output_dir": os.path.join(out_dir, "run"),
            "solver": {"gmres_tol": 1e-4, "gmres_restart": 20,
                       "gmres_maxiter": 60, "lanczos_iters": 8,
                       "pc_mode": "block_free", "image_shells": PF_SHELLS,
                       "matvec_row_tile": 512}}
    path = os.path.join(out_dir, f"film_{n_steps}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path, conf


def run_driver(run, argv):
    """``run.main(argv)`` with its standard output captured and echoed;
    returns its JSON lines."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run.main(argv)
    out = buf.getvalue()
    print(out, end="")
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def poly_box_entries(pf_t, pf_errs, name, launches, launches_per_step):
    """A kernel's POLY × BOX keys of the summary line, at the polydisperse
    film (10,296 blobs, (10, 10) box): its time at image_shells 0 and
    PF_SHELLS and the main path's RHS, its box and POLY forms' in turns at
    the same positions, the plain float32 sweep's, the bound, the max abs
    error against float64 (wall), and its launches on the driver's run."""
    out = {"poly_box_form_in": 11, "launches_poly_film": launches,
           "launches_per_step_poly_film": launches_per_step}
    for S, v in pf_t[name].items():
        out.update({f"ms_poly_box_s{S}": v["ms"],
                    f"plain_ms_poly_box_s{S}": v["plain_ms"],
                    f"bound_ms_poly_box_s{S}": v["bound"][0],
                    f"bound_ratio_poly_box_s{S}": v["ms"] / v["bound"][0],
                    f"max_abs_err_poly_box_s{S}":
                        pf_errs[name, True, S, v["k"]]})
        if "ms_box" in v:
            out.update({f"ms_box_at_poly_film_s{S}": v["ms_box"],
                        f"ms_poly_at_poly_film_s{S}": v["ms_poly"]})
    return out


def step_split(torch, profiling, label, run, steps):
    """Run ``run(steps)`` under the step timer; print and return the split:
    ms a step by CUDA events, each part's own ms a step (less the parts
    nested in it), and the GMRES loop's own share (its host iterations)."""
    with profiling.StepTimer() as timer:
        run(steps)
    split = timer.split()
    step_ms = split["step"]["ms"] / steps
    own = {k: v["self_ms"] / steps for k, v in split.items()}
    kernels = sum(own.get(k, 0.0) for k in ("pair_sweep_sym",
                                             "pair_sweep_ordered",
                                             "near_sweep", "near_sweep_slice",
                                             "ewald_real_sweep",
                                             "ewald_real_slab",
                                             "ewald_real_tiles"))
    print(f"step split, {label} slice, {steps} step(s): {step_ms:.3f} ms a "
          f"step; kernels {kernels:.3f}, GMRES loop (own) "
          f"{own.get('gmres', 0.0):.3f} ms a step; own ms a step by part: "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(own.items(), key=lambda kv: -kv[1])))
    return {"slice": label, "steps": steps, "step_ms": step_ms,
            "kernels_ms": kernels, "gmres_own_ms": own.get("gmres", 0.0),
            "own_ms": own,
            "count": {k: v["count"] / steps for k, v in split.items()}}


def check_ewald_sweep(torch, ewald, ewald_cuda, label, r32, F32, params,
                      rows=None):
    """K4 (float32) against the plain sweep in float64 on the same
    float32-representable inputs and the same Chebyshev fit, 1 and 2 RHS,
    on every row or on the sampled ``rows``; the plain float32 sweep's
    error is printed beside it (what float32 Clenshaw costs whoever
    evaluates it).  Returns the max absolute error at 1 RHS."""
    r64, F64 = r32.double(), F32.double()
    ids = torch.arange(r32.shape[0], device=r32.device)
    rows = ids if rows is None else rows

    def plain(r, F, k, cheb):
        return ewald.real_space_block(r[rows], rows, r, ids, F[:k], params,
                                      cheb=cheb)

    err1 = None
    for k in (1, 2):
        U = ewald_cuda.real_pair_sum(F32[:k], r32, params)[:, rows]
        torch.cuda.synchronize()
        ref = plain(r64, F64, k, True)
        err = (U.double() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        rel_plain = ((plain(r32, F32, k, None).double() - ref).abs().max()
                     / ref.abs().max()).item()
        print(f"K4 ewald_real_sweep {label} n={r32.shape[0]} box={params.box}"
              f" degree={params.cheb_A.shape[1] - 1} k={k}: max|dU|={err:.3e}"
              f" max|dU|/max|U|={rel:.3e} (tol {KERNEL_TOL:g}); the plain "
              f"float32 sweep {rel_plain:.3e}")
        if not (rel <= KERNEL_TOL and torch.isfinite(U).all()):
            raise AssertionError(f"K4 disagrees with the plain sweep on "
                                 f"{label}, k={k}: {rel}")
        if err1 is None:
            err1 = err
    return err1


def near_pairs(torch, ctx, tile, wrap_cells=None):
    """The pairs K3 must evaluate on this data: live rows against their
    neighbor tiles' live columns, cell offset ≤ 1 on every axis (cyclic in
    x/y on ``wrap_cells``), not the self pair."""
    live = ctx.id_s >= 0
    lane = torch.arange(tile, device=live.device)
    total = 0
    for c0 in range(0, ctx.nbr.shape[0], 8):
        nb = ctx.nbr[c0:c0 + 8].long()
        ch = nb.shape[0]
        cols = (nb.clamp(min=0)[..., None] * tile + lane).reshape(ch, -1)
        col_ok = ((nb >= 0)[..., None].expand(-1, -1, tile).reshape(ch, -1)
                  & live[cols])
        rows = (torch.arange(c0, c0 + ch, device=live.device)[:, None] * tile
                + lane)
        dc = (ctx.ci_s[rows][:, :, None, :]
              - ctx.ci_s[cols][:, None, :, :]).abs()
        for ax, g in enumerate(wrap_cells or ()):
            dc[..., ax] = torch.minimum(dc[..., ax], g - dc[..., ax])
        keep = ((dc <= 1).all(dim=-1) & col_ok[:, None, :]
                & live[rows][:, :, None]
                & (rows[:, :, None] != cols[:, None, :]))
        total += int(keep.sum())
    return total


def check_near(torch, farfield, farfield_cuda, label, r64, a, grid):
    """K3 (float32) against the plain near sweep (float64) on the sorted
    tiles of r64, wall and free, 1 and 2 RHS; live rows only (pad rows are
    garbage by contract)."""
    rng = np.random.default_rng(SEED + 1)
    for wall in (True, False):
        ctx = farfield.prepare(r64, a=a, wall=wall, grid=grid, p=FF_P)
        live = ctx.id_s >= 0
        F = torch.from_numpy(rng.standard_normal(
            (2, ctx.x_s.shape[0], 3))).to(r64.device)
        for k in (1, 2):
            U = farfield_cuda.near_sweep(ctx.x_s, ctx.ci_s, live, F[:k],
                                         ctx.nbr, wall, 0.75,
                                         pairs=(ctx.pairs, ctx.n_pairs))
            torch.cuda.synchronize()
            ref = farfield._near_sweep(ctx.x_s, ctx.ci_s, ctx.id_s, F[:k],
                                       ctx.nbr, wall, 0.75)
            err = (U.double() - ref)[:, live].abs().max().item()
            rel = err / ref[:, live].abs().max().item()
            print(f"K3 near_sweep {label} n={r64.shape[0]} wall={wall} k={k}:"
                  f" max|dU|={err:.3e} max|dU|/max|U|={rel:.3e} "
                  f"(tol {KERNEL_TOL:g})")
            if not (rel <= KERNEL_TOL and torch.isfinite(U[:, live]).all()):
                raise AssertionError(f"K3 disagrees with the plain sweep on "
                                     f"{label}, wall={wall}, k={k}: {rel}")


def film_near_clouds():
    """Edge clouds for K3's box form, float32 in units of a, each with its
    box and grid: "ragged" (1,500 blobs over 1.4 periods in x and y,
    heights across the 0.75a floor; (24, 20) box, (6, 5, 2) grid); "ties"
    (a g = 4 grid, 2h = L/2, in a (16, 16) box: blobs at −1e-7 wrap to
    exactly L, their cell clipped to 3, and pair with blobs at L/2 (cell 2)
    on the seam tie and one ulp inside it; one ulp past it the cells are
    not adjacent; x and y, among 400 others); "self" (168 blobs along one
    y row, 42 a cell, on a (4, 4, 1) grid: the first tile spans every x
    cell and meets itself across the seam, the second is its neighbor
    directly and across the seam).  tests/test_torch_cuda.py holds K3's
    box form on them too."""
    rng = np.random.default_rng(11)
    out = {}
    r = rng.uniform([-4, -4, 0.3], [28, 24, 6], (1500, 3))
    out["ragged"] = (r, (24.0, 20.0), (6, 5, 2))
    half = np.float32(8.0)
    up, down = np.nextafter(half, 9), np.nextafter(half, 7)
    seam = [(-1e-7, 3.0), (half, 3.0), (-1e-7, 6.0), (up, 6.0),
            (-1e-7, 9.0), (down, 9.0), (3.0, -1e-7), (3.0, half),
            (6.0, -1e-7), (6.0, up)]
    r = rng.uniform([0, 0, 0.3], [16, 16, 4], (400, 3))
    r = np.concatenate([np.array([(x, y, 1.5) for x, y in seam]), r])
    out["ties"] = (r, (16.0, 16.0), (4, 4, 1))
    r = rng.uniform([0, 0.5, 0.3], [16, 3.5, 2], (168, 3))
    r[:, 0] = (np.arange(168) + 0.5) * (16.0 / 168)
    out["self"] = (r, (16.0, 16.0), (4, 4, 1))
    return {k: (v[0].astype(np.float32),) + v[1:] for k, v in out.items()}


def host_ms(torch, fn, reps):
    """Mean host-clock milliseconds per call over ``reps`` calls after one
    warm-up, the calls ending in a device synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def launches(counters):
    """The nonzero launch counts of the kernel wrappers ``counters``."""
    out = {}
    for mod in counters:
        out.update({k: v for k, v in mod.launch_counts().items() if v})
    return out


def reset_launches(counters):
    for mod in counters:
        mod.reset_launch_counts()


@contextlib.contextmanager
def plain_sweep_calls(rpy):
    """Count the plain pair sweep's calls (``rpy.pair_sum``, which every
    plain mobility product goes through) inside the block."""
    calls = [0]
    orig = rpy.pair_sum

    def counting(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)

    rpy.pair_sum = counting
    try:
        yield calls
    finally:
        rpy.pair_sum = orig


def raises_below_wall(fn):
    """Whether ``fn`` raises the reference's below-the-wall RuntimeError."""
    try:
        fn()
    except RuntimeError as e:
        return "below the wall" in str(e)
    return False


def rigid_body_dense(torch, dev, cfg, force, counters):
    """Phase 40: the RigidBody API at the dense slice (10,272 blobs,
    ``config=`` the slice's configuration, validate_config on).  Returns
    the phase's readings."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch.dynamics import (make_draws, run_bd,
                                                     stochastic_step)
    from rigid_body_light_tpu_torch.ops import kinematics as kin
    from rigid_body_light_tpu_torch.ops import rpy, saddle, solvers
    from rigid_body_light_tpu_torch.utils import validation

    out = {}
    params, ref = rt.load_structure(SHELL)
    xs, qs = slice_placements()
    cfg = cfg.replace(validate_config=True)
    for key in ("construct_first_ms", "construct_ms"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rb = rt.RigidBody(ref, xs, qs, cfg.a, cfg.eta, cfg.dt, config=cfg)
        torch.cuda.synchronize()
        out[key] = (time.perf_counter() - t0) * 1e3
    r = rb._ops.flat_positions
    q1 = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev)
    out["diagnose_ms"] = host_ms(torch, lambda: float(validation.diagnose(
        r, q1, a=cfg.a).min_separation), 3)
    out["min_separation"] = float(validation.diagnose(
        r, q1, a=cfg.a).min_separation)
    n, B = rb.total_blobs, rb.N_bodies
    print(f"RigidBody at the dense slice: {B} x {SHELL} = {n} blobs, "
          f"construction {out['construct_ms']:.2f} ms (first "
          f"{out['construct_first_ms']:.2f} ms; the overlap diagnose alone "
          f"{out['diagnose_ms']:.2f} ms, min separation "
          f"{out['min_separation']:.4f} a)")

    # each operator: ms a call with numpy in and out, the same function on
    # device tensors, the launches of one numpy call
    rng = np.random.default_rng(SEED + 40)
    n_sys = 3 * n + 6 * B
    U_np = rng.standard_normal(6 * B)
    lam_np = rng.standard_normal(3 * n)
    x_np = rng.standard_normal(n_sys)
    F_np = rng.standard_normal(3 * n)
    pos = rb.get_blob_positions()
    force_np = force.cpu().numpy().astype(np.float64)
    U_res_np = rb.solve_mobility(force_np)[0]
    ops, pc = rb._ops, rb._pc
    d = dict(device=dev, dtype=torch.float32)
    U_d = torch.tensor(U_np, **d).reshape(-1, 6)
    lam_d = torch.tensor(lam_np, **d).reshape(-1, 3)
    x_d = torch.tensor(x_np, **d)
    F_d = torch.tensor(F_np, **d).reshape(-1, 3)
    U_res_d = torch.tensor(U_res_np, **d)
    slip0 = torch.zeros((n, 3), **d)
    mob = saddle.mobility_apply_fn(cfg)
    calls = {
        "K_dot": (lambda: rb.K_dot(U_np),
                  lambda: kin.K_dot(U_d, ops.offsets)),
        "KT_dot": (lambda: rb.KT_dot(lam_np),
                   lambda: kin.KT_dot(lam_d.reshape(B, -1, 3), ops.offsets)),
        "apply_PC": (lambda: rb.apply_PC(x_np),
                     lambda: saddle.apply_pc(pc, x_d[:3 * n].reshape(-1, 3),
                                             x_d[3 * n:].reshape(-1, 6), ops,
                                             cfg)),
        "apply_M": (lambda: rb.apply_M(F_np, pos),
                    lambda: mob(F_d, ops.flat_positions)),
        "apply_saddle": (lambda: rb.apply_saddle(x_np),
                         lambda: saddle.apply_saddle(
                             x_d[:3 * n].reshape(-1, 3),
                             x_d[3 * n:].reshape(-1, 6), ops, cfg)),
        "solve_mobility": (lambda: rb.solve_mobility(force_np),
                           lambda: solvers.solve_saddle(ops, cfg, slip0, force,
                                                        pc=pc)),
        "solve_resistance": (
            lambda: solvers.solve_resistance(rb._ops, cfg, U_res_np)[0]
            .cpu().numpy(),
            lambda: solvers.solve_resistance(ops, cfg, U_res_d)),
    }
    reps = {"solve_mobility": 3, "solve_resistance": 3}
    ops_out = {}
    with plain_sweep_calls(rpy) as plain:
        for name, (api_fn, dev_fn) in calls.items():
            k = reps.get(name, 20)
            api = host_ms(torch, api_fn, k)
            raw = host_ms(torch, dev_fn, k)
            reset_launches(counters)
            plain[0] = 0
            api_fn()
            torch.cuda.synchronize()
            cnt = launches(counters)
            ops_out[name] = dict(api_ms=api, device_ms=raw, launches=cnt,
                                 plain_sweep_calls=plain[0])
            print(f"  {name}: {api:.4f} ms a numpy call, {raw:.4f} ms on "
                  f"device tensors; launches of one call {cnt}, plain "
                  f"sweep calls {plain[0]}")
    out["operators"] = ops_out
    for name in ("apply_M", "apply_saddle", "solve_mobility",
                 "solve_resistance"):
        o = ops_out[name]
        if not (o["launches"].get("pair_sweep_sym", 0) > 0
                and o["plain_sweep_calls"] == 0
                and "pair_sweep_ordered" not in o["launches"]):
            raise AssertionError(f"RigidBody {name} did not go through K1 "
                                 f"alone: {o}")

    # apply_M against the dense float64 operator and the plain float32 sweep
    U_api = rb.apply_M(F_np, pos)
    F32 = torch.tensor(F_np, **d).reshape(-1, 3)
    r32 = torch.from_numpy(pos).to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U_dense = rpy.apply_M_dense(F32.double(), r32.double(), a=cfg.a,
                                eta=cfg.eta, wall=True,
                                h_floor=cfg.wall_h_floor)
    torch.cuda.synchronize()
    out["apply_M_dense_ms"] = (time.perf_counter() - t0) * 1e3
    out["apply_M_dense_peak_bytes"] = torch.cuda.max_memory_allocated()
    U_dense = U_dense.cpu().numpy().ravel()
    torch.cuda.empty_cache()
    U_plain = saddle.mobility_apply_fn(cfg.replace(use_pallas=False))(
        F32, r32).cpu().numpy().ravel()
    scale = np.abs(U_dense).max()
    out["apply_M_vs_dense"] = float(np.abs(U_api - U_dense).max() / scale)
    out["apply_M_vs_plain"] = float(np.abs(U_api - U_plain).max()
                                    / np.abs(U_plain).max())
    print(f"  apply_M vs apply_M_dense (float64, {3 * n}^2 entries, "
          f"{out['apply_M_dense_ms']:.1f} ms, peak "
          f"{out['apply_M_dense_peak_bytes'] / 1e9:.2f} GB): max|dU|/max|U| "
          f"= {out['apply_M_vs_dense']:.3e}; vs the plain float32 sweep "
          f"{out['apply_M_vs_plain']:.3e} (tol {KERNEL_TOL:g})")
    if not (out["apply_M_vs_dense"] <= KERNEL_TOL
            and out["apply_M_vs_plain"] <= KERNEL_TOL):
        raise AssertionError(f"RigidBody.apply_M disagrees: {out}")

    # the resistance solve inverts the mobility solve
    U_s, _, res_s = rb.solve_mobility(force_np)
    F_back, _, res_r = solvers.solve_resistance(rb._ops, cfg, U_s)
    F_back = F_back.cpu().numpy()
    out["roundtrip_rel"] = float(np.abs(F_back - force_np).max()
                                 / np.abs(force_np).max())
    out["solve_residuals"] = [res_s, float(res_r)]
    print(f"  solve_resistance(solve_mobility(F).U) vs F: max|dF|/max|F| = "
          f"{out['roundtrip_rel']:.3e} (tol {ROUNDTRIP_TOL * cfg.gmres_tol:g}"
          f"); residuals {res_s:.3e}, {float(res_r):.3e}")
    if not (out["roundtrip_rel"] <= ROUNDTRIP_TOL * cfg.gmres_tol
            and max(out["solve_residuals"]) < 10 * cfg.gmres_tol):
        raise AssertionError(f"the resistance round trip failed: {out}")

    # a step from given draws: bitwise the stepper's, K1 and K2 launched
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    st0 = rb.state
    draws = make_draws(rb._geom, st0, gen)
    reset_launches(counters)
    U_step = rb.stochastic_step(force_np, draws=draws)
    torch.cuda.synchronize()
    cnt = launches(counters)
    st_ref, aux_ref = stochastic_step(rb._geom, cfg, st0, force, draws=draws)
    bitwise = (torch.equal(rb.state.X, st_ref.X)
               and torch.equal(rb.state.Q, st_ref.Q)
               and np.array_equal(U_step, aux_ref.U.cpu().numpy()))
    out["step"] = dict(bitwise=bitwise, launches=cnt)
    print(f"  stochastic_step from given draws bitwise equal to "
          f"dynamics.stochastic_step: {bitwise}; launches {cnt}")
    if not (bitwise and cnt.get("pair_sweep_sym", 0) > 0
            and cnt.get("pair_sweep_ordered", 0) > 0):
        raise AssertionError(f"RigidBody.stochastic_step failed: {out['step']}")

    # RigidBody.run against run_bd in turns, 1 warm-up then the timed steps
    rb.run(WARM_STEPS, generator=gen, force_fn=lambda s_, i: force)
    sps = {"run_bd": [], "RigidBody.run": []}
    res_all, cnt_run = [], {}
    for who in ("run_bd", "RigidBody.run", "RigidBody.run", "run_bd"):
        torch.cuda.synchronize()
        reset_launches(counters)
        t0 = time.perf_counter()
        if who == "run_bd":
            _, tr = run_bd(rb._geom, cfg, rb.state, TIMED_STEPS, generator=gen,
                           force_fn=lambda s_, i: force)
            tr = {k: v.cpu().numpy() for k, v in tr.items()}
        else:
            tr = rb.run(TIMED_STEPS, generator=gen,
                        force_fn=lambda s_, i: force)
        torch.cuda.synchronize()
        sps[who].append(TIMED_STEPS / (time.perf_counter() - t0))
        if who == "RigidBody.run":
            res_all.append(tr["residual"])
            for k_, v_ in launches(counters).items():
                cnt_run[k_] = cnt_run.get(k_, 0) + v_
    res_all = np.concatenate(res_all)
    qerr = float(np.abs(np.linalg.norm(rb.get_config()[1], axis=1) - 1).max())
    out["run"] = dict(steps_per_s=sps, max_residual=float(res_all.max()),
                      max_quat_err=qerr, launches=cnt_run)
    print(f"  RigidBody.run vs run_bd in turns (run_bd, run, run, run_bd), "
          f"{TIMED_STEPS} steps each: {sps} steps/s; max residual "
          f"{res_all.max():.3e}; ||q|-1| {qerr:.2e}; launches over the two "
          f"runs {cnt_run}")
    if not (res_all.max() < 10 * cfg.gmres_tol and qerr <= 1e-5
            and cnt_run.get("pair_sweep_sym", 0) > 0
            and cnt_run.get("pair_sweep_ordered", 0) > 0):
        raise AssertionError(f"RigidBody.run failed: {out['run']}")

    # a body moved below the wall: the wall RuntimeError on the card
    X_keep, Q_keep = rb.get_config()
    X_low = X_keep.copy()
    X_low[0, 2] = 0.5
    rb.set_config(X_low, Q_keep)
    raised = {
        "apply_PC": raises_below_wall(lambda: rb.apply_PC(x_np)),
        "apply_saddle": raises_below_wall(lambda: rb.apply_saddle(x_np)),
        "apply_M": raises_below_wall(
            lambda: rb.apply_M(F_np, rb.get_blob_positions())),
    }
    print(f"  below the wall raises: {raised}")
    if not all(raised.values()):
        raise AssertionError(f"the below-wall contract failed: {raised}")

    # float64: the plain sweep, as the JAX package routes it (the kernels
    # are float32 only)
    p42, ref42 = rt.load_structure("shell_N_42")
    X42 = np.array([[2.5 * (i % 2), 2.5 * (i // 2), 2.0 + 0.2 * i]
                    for i in range(4)])
    rb64 = rt.RigidBody(ref42, X42, np.tile([1.0, 0, 0, 0], (4, 1)),
                        p42["sep"] / 2, cfg.eta, cfg.dt,
                        config=cfg.replace(dtype=torch.float64))
    F42 = np.zeros((4, 6))
    F42[:, 2] = -1.0
    reset_launches(counters)
    U64, _, res64 = rb64.solve_mobility(F42)
    cnt64 = launches(counters)
    out["float64"] = dict(residual=res64, launches=cnt64)
    print(f"  float64 RigidBody (4 x shell_N_42) solve_mobility: residual "
          f"{res64:.3e}, launches {cnt64}")
    if not (res64 < cfg.gmres_tol and not cnt64 and np.isfinite(U64).all()):
        raise AssertionError(f"the float64 RigidBody failed: {out['float64']}")
    return out


def rigid_body_farfield(torch, dev, counters):
    """Phase 41: the RigidBody API at the far-field slice (102,480 blobs,
    ``config=`` its configuration, validate_config on).  Returns the
    phase's readings."""
    import warnings

    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch.ops import rpy_cuda
    from rigid_body_light_tpu_torch.utils import validation

    out = {}
    cfg_f, _, _, force_f = farfield_setup(torch, dev, FF_BODIES)
    xs, qs = farfield_placements(FF_BODIES)
    _, ref = rt.load_structure(FF_SHELL)
    with warnings.catch_warnings():
        # the slice's gmres_tol lies below the p = 4 operator error
        warnings.simplefilter("ignore", UserWarning)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rb = rt.RigidBody(ref, xs, qs, cfg_f.a, cfg_f.eta, cfg_f.dt,
                          config=cfg_f)
        torch.cuda.synchronize()
    out["construct_ms"] = (time.perf_counter() - t0) * 1e3
    cfg = rb.config
    r = rb._ops.flat_positions
    n = r.shape[0]
    q1 = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev)
    out["diagnose_ms"] = host_ms(torch, lambda: float(validation.diagnose(
        r, q1, a=cfg.a).min_separation), 2)
    print(f"RigidBody at the far-field slice: {FF_BODIES} x {FF_SHELL} = {n} "
          f"blobs, construction {out['construct_ms']:.1f} ms (the overlap "
          f"diagnose over {n * (n - 1) / 1e9:.2f}e9 ordered pairs alone "
          f"{out['diagnose_ms']:.1f} ms)")
    rng = np.random.default_rng(SEED + 41)
    F_np = rng.standard_normal(3 * n)
    pos = rb.get_blob_positions()
    force_np = force_f.cpu().numpy().astype(np.float64)
    calls = {
        "apply_M": lambda: rb.apply_M(F_np, pos),
        "solve_mobility": lambda: rb.solve_mobility(force_np),
        "deterministic_step": lambda: rb.deterministic_step(force_np),
    }
    X0 = rb.get_config()[0]
    res = {}
    for name, fn in calls.items():
        # the launches and time of the first call, then (but for the step)
        # the time of a second
        times = []
        for _ in range(1 if name == "deterministic_step" else 2):
            reset_launches(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if len(times) == 1:
                cnt = launches(counters)
        out[name] = dict(api_ms=times[-1], first_ms=times[0], launches=cnt)
        print(f"  {name}: {times[-1]:.2f} ms a numpy call (first call "
              f"{times[0]:.2f} ms; the far field's setup included); launches "
              f"of one call {cnt}")
        if not (cnt.get("near_sweep", 0) > 0
                and "pair_sweep_sym" not in cnt
                and "pair_sweep_ordered" not in cnt):
            raise AssertionError(f"RigidBody {name} at the far-field slice "
                                 f"did not go through K3 alone: {cnt}")
    U_ex = rpy_cuda.mobility_apply(
        torch.tensor(F_np, device=dev, dtype=torch.float32).reshape(-1, 3),
        torch.from_numpy(pos).to(dev), a=cfg.a, eta=cfg.eta,
        wall=True).cpu().numpy().ravel()
    out["apply_M_vs_exact"] = float(np.abs(res["apply_M"] - U_ex).max()
                                    / np.abs(U_ex).max())
    out["solve_residual"] = res["solve_mobility"][2]
    moved = float(np.abs(rb.get_config()[0] - X0).max())
    print(f"  apply_M vs the exact operator (K1): max|dU|/max|U| = "
          f"{out['apply_M_vs_exact']:.3e} (tol {FF_OPERATOR_TOL:g}); "
          f"solve_mobility residual {out['solve_residual']:.3e}; the step "
          f"moved a body by {moved:.3e}")
    if not (out["apply_M_vs_exact"] <= FF_OPERATOR_TOL
            and out["solve_residual"] < 10 * cfg.gmres_tol
            and np.isfinite(res["deterministic_step"]).all() and moved > 0):
        raise AssertionError(f"RigidBody at the far-field slice failed: "
                             f"{out}")
    return out


def op_rel(U, ref):
    """max|U − ref| / max|ref| in float64."""
    U, ref = U.double(), ref.double()
    return ((U - ref).abs().max() / ref.abs().max()).item()


def nbr_tiles(ewald_cells, r):
    """The neighbor-list width of the balanced-split phases: the tile
    count, which no tile can overflow.  On a lattice of bodies a tile whose
    column clips two bodies spans the gap between them, so the most
    neighbors a tile has (ewald_cells.neighbor_width, printed by phases 42
    and 44) lies far above the uniform-density default and moves a lot
    with the bodies; the sweep's cost follows the live tile pairs, not the
    width."""
    return -(-r.shape[0] // ewald_cells.TILE)


def balanced_split_setup(torch, device):
    """The balanced-split slice: 180 x shell_N_642 at the points of a
    6 x 6 x 5 lattice (spacing 5.0, 5.0, 6.0, offset 0.5), identity
    quaternions, in a cubic L = 30 box; a = sep/2, float32, no wall, no
    force, dt 0.01, kBT 1, ewald_tol 1e-4, ewald_rc 3.5, ewald_grid_p 4,
    block_free, 6 preconditioned Lanczos iterations, GMRES tol 1e-4,
    restart 60 / maxiter 60 (the periodic slice's settings,
    scripts/tpu_ewald_bench.py:89-93).  Returns (cfg, geom, state)."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    params, ref = rt.load_structure(SHELL)
    nx, ny, nz = BS_SIDE
    xs = np.array([[BS_SPACING[0] * i + 0.5, BS_SPACING[1] * j + 0.5,
                    BS_SPACING[2] * k + 0.5]
                   for i in range(nx) for j in range(ny) for k in range(nz)])
    qs = np.tile([1.0, 0, 0, 0], (len(xs), 1))
    cfg = rt.SimulationConfig(
        a=params["sep"] / 2, dt=0.01, kBT=1.0, box=BS_BOX, wall=False,
        dtype=torch.float32, lanczos_iters=6, gmres_tol=1e-4,
        gmres_restart=60, gmres_maxiter=60, pc_mode="block_free",
        ewald_tol=EW_TOL, ewald_rc=BAL_RC, ewald_grid_p=BAL_P)
    geom = kin.make_ref_geometry(ref, dtype=torch.float32, device=device)
    state = rt.make_state(xs, qs, dtype=torch.float32, device=device)
    return cfg, geom, state


def balanced_split_phases(torch, dev, counters):
    """Phases 42-45: the balanced split (the tile sweep of ops/ewald_cells
    through K4 tiles, the gridded wave part of ops/ewald_pme, per-blob
    radii).  Returns the phases' readings."""
    import rigid_body_light_tpu_torch as rt
    from rigid_body_light_tpu_torch import multi
    from rigid_body_light_tpu_torch.dynamics import (make_draws, run_bd,
                                                     stochastic_step)
    from rigid_body_light_tpu_torch.ops import (ewald, ewald_cells,
                                                ewald_cuda, ewald_pme,
                                                kinematics as kin, saddle)
    from rigid_body_light_tpu_torch.utils import profiling

    out = {}
    rng = np.random.default_rng(SEED + 42)

    # ---- 42. the balanced split against the classic split through K4 at
    # the periodic slice's positions
    torch.cuda.empty_cache()
    cfg_e, geom_e, state_e = ewald_setup(torch, dev)
    r = kin.blob_positions(geom_e, state_e.X, state_e.Q).reshape(-1, 3)
    n = r.shape[0]
    F = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev).float()
    par_c = ewald.make_params(EW_BOX, cfg_e.a, cfg_e.eta, tol=EW_TOL)
    par_b = ewald.make_params(EW_BOX, cfg_e.a, cfg_e.eta, tol=EW_TOL,
                              rc=BAL_RC)
    g_b = ewald_pme.make_grid(par_b, p=BAL_P)
    max_nbr = nbr_tiles(ewald_cells, r)
    ph42 = dict(n=n, rc=BAL_RC, p=BAL_P, max_nbr=max_nbr,
                neighbor_width=ewald_cells.neighbor_width(r, par_b),
                default_max_nbr=ewald_cells.default_max_nbr(n, par_b),
                tiles=-(-n // ewald_cells.TILE), grid=list(g_b.grid),
                k_vectors=len(par_b.kvecs),
                k_vectors_classic=len(par_c.kvecs))
    for k in (1, 2):
        Fk = F[:k]
        U_c = ewald_cuda.mobility_apply_multi(Fk, r, par_c)
        U_d = ewald.mobility_apply_multi(Fk, r, par_b, max_nbr=max_nbr)
        U_g = ewald.mobility_apply_multi(Fk, r, par_b, max_nbr=max_nbr,
                                         grid=g_b)
        if k == 1:
            U_g1 = ewald.mobility_apply(F[0], r, par_b, max_nbr=max_nbr,
                                        grid=g_b)
            ph42["single_vs_multi"] = op_rel(U_g1, U_g[0])
        ph42[f"dense_rel_{k}"] = op_rel(U_d, U_c)
        ph42[f"grid_rel_{k}"] = op_rel(U_g, U_c)
    # the tile sweep against the float64 all-pairs sweep with the same cut
    # on the same float32 inputs (the float64 Clenshaw of the same fit)
    U_cells = ewald_cells.real_space_apply_cells(F, r, par_b, max_nbr)
    U_all64 = ewald.real_space_apply(F.double(), r.double(), par_b,
                                     cheb=True)
    U_all32 = ewald.real_space_apply(F, r, par_b)
    ph42["cells_vs_allpairs64"] = op_rel(U_cells, U_all64)
    ph42["allpairs32_vs_allpairs64"] = op_rel(U_all32, U_all64)
    ph42["cells_repeat_bitwise"] = bool(torch.equal(
        U_cells, ewald_cells.real_space_apply_cells(F, r, par_b, max_nbr)))
    del U_all64, U_all32
    for k in (1, 2):
        Fk = F[:k].contiguous()
        ph42[f"cells_ms_{k}"] = cuda_ms(
            torch, lambda: ewald_cells.real_space_apply_cells(
                Fk, r, par_b, max_nbr), 5)
        ph42[f"pme_ms_{k}"] = cuda_ms(
            torch, lambda: ewald_pme.wave_space_apply_grid(Fk, r, par_b, g_b),
            5)
        ph42[f"dense_wave_ms_{k}"] = cuda_ms(
            torch, lambda: ewald.wave_space_apply(Fk, r, par_b), 5)
        ph42[f"k4_operator_ms_{k}"] = cuda_ms(
            torch, lambda: ewald_cuda.mobility_apply_multi(Fk, r, par_c), 5)
        ph42[f"balanced_operator_ms_{k}"] = cuda_ms(
            torch, lambda: ewald.mobility_apply_multi(
                Fk, r, par_b, max_nbr=max_nbr, grid=g_b), 5)
    print(f"phase 42, the balanced split at the periodic slice's {n} "
          f"positions (L = {EW_BOX[0]:g}, rc {BAL_RC}, p {BAL_P}): "
          + json.dumps(ph42))
    checks = {
        "dense wave within the bound of K4's classic split, 1 and 2 RHS":
            max(ph42["dense_rel_1"], ph42["dense_rel_2"]) <= BAL_OPERATOR_TOL,
        "gridded wave within the bound, 1 and 2 RHS":
            max(ph42["grid_rel_1"], ph42["grid_rel_2"]) <= BAL_OPERATOR_TOL,
        "the tile sweep is the all-pairs sweep with the rc cut":
            ph42["cells_vs_allpairs64"] <= KERNEL_TOL,
        "the tile sweep repeats bitwise": ph42["cells_repeat_bitwise"],
        "1-RHS and 2-RHS applies agree": ph42["single_vs_multi"] <= 1e-6,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"phase 42 failed: {what}: {ph42}")
    out["phase42"] = ph42
    del U_cells, U_c, U_d, U_g

    # ---- 43. the JAX package's PME bench case at L = 30 (ROADMAP queue 3,
    # fault 3): both cutoffs against the classic split through K4, and the
    # operator split into its parts
    torch.cuda.empty_cache()
    rng0 = np.random.default_rng(0)
    L = PME_BENCH_L
    r43 = torch.from_numpy(rng0.uniform(0, L, (PME_BENCH_N, 3))).to(
        dev).float()
    F43 = torch.from_numpy(rng0.standard_normal((PME_BENCH_N, 3))).to(
        dev).float()
    par_c43 = ewald.make_params((L, L, L), PME_BENCH_A, 1.0, tol=EW_TOL)
    U_c43 = ewald_cuda.mobility_apply(F43, r43, par_c43)
    ph43 = dict(n=PME_BENCH_N, L=L, a=PME_BENCH_A,
                k4_operator_ms=cuda_ms(torch, lambda: ewald_cuda.mobility_apply(
                    F43, r43, par_c43), 3))
    rows = torch.from_numpy(np.sort(rng.choice(
        PME_BENCH_N, SCALE_ROWS, replace=False))).to(dev)
    ids43 = torch.arange(PME_BENCH_N, device=dev)
    for rc in PME_BENCH_RCS:
        par = ewald.make_params((L, L, L), PME_BENCH_A, 1.0, tol=EW_TOL,
                                rc=rc)
        g = ewald_pme.make_grid(par, p=BAL_P)
        w = nbr_tiles(ewald_cells, r43)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        U = ewald.mobility_apply(F43, r43, par, max_nbr=w, grid=g)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        rec = dict(k_vectors=len(par.kvecs), grid=list(g.grid), max_nbr=w,
                   neighbor_width=ewald_cells.neighbor_width(r43, par),
                   default_max_nbr=ewald_cells.default_max_nbr(PME_BENCH_N,
                                                               par),
                   rel_err=op_rel(U, U_c43), peak_bytes=peak,
                   operator_ms=cuda_ms(torch, lambda: ewald.mobility_apply(
                       F43, r43, par, max_nbr=w, grid=g), 3))
        # the parts: the tile sweep on sampled rows against the float64
        # all-pairs sweep with the same cut, the gridded wave part against
        # the dense (K-chunked) wave sum, and the classic split's own
        # parts beside them
        U_cells = ewald_cells.real_space_apply_cells(F43, r43, par, w)
        ref_rows = ewald.real_space_block(
            r43.double()[rows], rows, r43.double(), ids43, F43.double(),
            par, cheb=True)
        rec["cells_rows_vs_allpairs64"] = op_rel(U_cells[rows], ref_rows)
        U_pme = ewald_pme.wave_space_apply_grid(F43, r43, par, g)
        U_dw = ewald.wave_space_apply(F43, r43, par)
        rec["pme_vs_dense_wave"] = op_rel(U_pme, U_dw)
        rec["pme_ms"] = cuda_ms(torch, lambda: ewald_pme.wave_space_apply_grid(
            F43, r43, par, g), 3)
        rec["cells_ms"] = cuda_ms(
            torch, lambda: ewald_cells.real_space_apply_cells(F43, r43, par,
                                                              w), 3)
        ph43[f"rc{rc}"] = rec
        print(f"phase 43, rc = {rc} at {PME_BENCH_N} blobs in L = {L:g}: "
              + json.dumps(rec))
        del U, U_cells, U_pme, U_dw, ref_rows
        torch.cuda.empty_cache()
    out["phase43"] = ph43
    bad = [rc for rc in PME_BENCH_RCS
           if not ph43[f"rc{rc}"]["rel_err"] <= BAL_OPERATOR_TOL]
    if bad:
        raise AssertionError(f"phase 43: the balanced split departs from "
                             f"the classic split at rc {bad}: {ph43}")
    del r43, F43, U_c43

    # ---- 44. the balanced-split slice at 115,560 blobs through run_bd
    torch.cuda.empty_cache()
    cfg_s, geom_s, state_s = balanced_split_setup(torch, dev)
    n_s = geom_s.ref_cfg.shape[0] * state_s.X.shape[0]
    par_s = saddle._ewald_params(BS_BOX, cfg_s.a, cfg_s.eta, None, EW_TOL,
                                 BAL_RC)
    r_s = kin.blob_positions(geom_s, state_s.X, state_s.Q).reshape(-1, 3)
    cfg_s = cfg_s.replace(ewald_nbr_tiles=nbr_tiles(ewald_cells, r_s))
    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    x0 = state_s.X.clone()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches(counters)
    s1, tr_w = run_bd(geom_s, cfg_s, state_s, BS_WARM_STEPS, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s1, tr_s = run_bd(geom_s, cfg_s, s1, BS_TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cnt = launches(counters)
    res = torch.cat([tr_w["residual"], tr_s["residual"]])
    qn = torch.linalg.norm(s1.Q, dim=1)
    ph44 = dict(n=n_s, bodies=state_s.X.shape[0], box=list(BS_BOX),
                steps_per_s=BS_TIMED_STEPS / wall,
                iters=torch.cat([tr_w["iters"], tr_s["iters"]]).tolist(),
                residuals=res.tolist(), max_residual=res.max().item(),
                max_q_dev=(qn - 1).abs().max().item(), launches=cnt,
                peak_bytes=torch.cuda.max_memory_allocated(dev),
                max_nbr=cfg_s.ewald_nbr_tiles,
                neighbor_width=ewald_cells.neighbor_width(r_s, par_s),
                default_max_nbr=ewald_cells.default_max_nbr(n_s, par_s))
    with profiling.StepTimer(dev) as timer:
        run_bd(geom_s, cfg_s, s1, 1, generator=gen)
    split = timer.split()
    own = {k: v["self_ms"] for k, v in split.items()}
    ph44["step_ms"] = split["step"]["ms"]
    ph44["own_ms"] = own
    ph44["mobility_split_ms"] = {
        "tile lists": own.get("ewald_tiles", 0.0),
        "tile kernel": own.get("ewald_real_tiles", 0.0),
        "rest of the tile sweep": own.get("ewald_cells", 0.0),
        "PME wave part": own.get("ewald_pme", 0.0),
        "rest": own.get("mobility", 0.0)}
    ph44["split_counts"] = {k: split[k]["count"] for k in (
        "ewald_tiles", "ewald_real_tiles", "ewald_pme") if k in split}
    # one step through the kernel against one through the plain tile
    # sweep (use_pallas=False), from the same draws
    zero_s = torch.zeros((s1.X.shape[0], 6), dtype=torch.float32,
                         device=dev)
    draws = make_draws(geom_s, s1, gen)
    s_k, aux_k = stochastic_step(geom_s, cfg_s, s1, zero_s, draws=draws)
    s_p, aux_p = stochastic_step(geom_s, cfg_s.replace(use_pallas=False),
                                 s1, zero_s, draws=draws)
    torch.cuda.synchronize()
    dX_k, dX_p = s_k.X - s1.X, s_p.X - s1.X
    ph44["kernel_vs_plain_step"] = dict(
        rel_dx=((dX_k - dX_p).abs().max() / dX_p.abs().max()).item(),
        iters=[int(aux_k.iters), int(aux_p.iters)],
        residuals=[aux_k.residual.item(), aux_p.residual.item()])
    del s_k, s_p, draws
    print(f"phase 44, the balanced-split slice: {ph44['bodies']} x {SHELL} ="
          f" {n_s} blobs in L = {BS_BOX[0]:g}, rc {BAL_RC}, p {BAL_P}: "
          + json.dumps(ph44))
    checks = {
        "max residual < 10 gmres_tol": ph44["max_residual"]
        < 10 * cfg_s.gmres_tol,
        "state finite": bool(torch.isfinite(s1.X).all()
                             and torch.isfinite(s1.Q).all()),
        "|q| within 1e-5 of 1": ph44["max_q_dev"] <= 1e-5,
        "bodies moved": (s1.X - x0).abs().max().item() > 0,
        "K4 tiles launched": cnt.get("ewald_real_tiles", 0) > 0,
        "no other kernel launched (K4 serves the classic split only)":
            set(cnt) == {"ewald_real_tiles"},
        "the kernel step within STEP_TOL of the plain step":
            ph44["kernel_vs_plain_step"]["rel_dx"] <= STEP_TOL,
        "the plain step's residual < 10 gmres_tol": max(
            ph44["kernel_vs_plain_step"]["residuals"]) < 10 * cfg_s.gmres_tol,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"phase 44 failed: {what}: {ph44}")
    # the RigidBody API at these positions: apply_M with numpy in and out
    # beside the device function
    _, ref = rt.load_structure(SHELL)
    rb = rt.RigidBody(ref, s1.X.cpu().numpy(), s1.Q.cpu().numpy(), cfg_s.a,
                      cfg_s.eta, cfg_s.dt, config=cfg_s, device=dev)
    pos = rb.get_blob_positions()
    F_np = rng.standard_normal(pos.size)
    U_api = rb.apply_M(F_np, pos)
    api_ms = host_ms(torch, lambda: rb.apply_M(F_np, pos), 2)
    mob = saddle.mobility_apply_fn(rb.config)
    F_dev = torch.tensor(F_np, device=dev, dtype=torch.float32).reshape(-1, 3)
    r_dev = torch.from_numpy(pos).to(dev).float().reshape(-1, 3)
    dev_ms = host_ms(torch, lambda: mob(F_dev, r_dev), 2)
    U_dev = mob(F_dev, r_dev).cpu().numpy().ravel()
    api_rel = float(np.abs(U_api - U_dev).max() / np.abs(U_dev).max())
    ph44["rigid_body_apply_M"] = dict(api_ms=api_ms, device_ms=dev_ms,
                                      rel_vs_device=api_rel)
    print(f"  RigidBody.apply_M at {n_s} blobs: {api_ms:.2f} ms a numpy call "
          f"(the overlap diagnose included), the device function "
          f"{dev_ms:.2f} ms; max|dU|/max|U| {api_rel:.3e}")
    if not api_rel <= KERNEL_TOL:
        raise AssertionError(f"RigidBody.apply_M departs from the device "
                             f"function: {api_rel}")
    out["phase44"] = ph44
    del rb, s1, state_s

    # ---- 45. the polydisperse periodic mixture through run_bd_multi
    torch.cuda.empty_cache()
    cfg_m, mgeom, states, forces = mixture_setup(torch, dev, poly=True)
    cfg_45 = cfg_m.replace(wall=False, box=EW_BOX, ewald_tol=EW_TOL,
                           ewald_rc=BAL_RC, ewald_grid_p=BAL_P)
    opses = multi.geometry_ops_multi(mgeom, states)
    radii = multi.blob_radii_multi(mgeom, opses, cfg_45)
    r45 = multi.concat_positions(opses)
    cfg_45 = cfg_45.replace(ewald_nbr_tiles=nbr_tiles(ewald_cells, r45))
    n45 = r45.shape[0]
    F45 = torch.from_numpy(rng.standard_normal((2, n45, 3))).to(dev).float()
    cfg_cl = cfg_45.replace(ewald_rc=0.0, ewald_grid_p=0)
    U_cl = saddle.mobility_apply_multi_fn(cfg_cl, radii=radii)(F45, r45)
    U_b2 = saddle.mobility_apply_multi_fn(cfg_45, radii=radii)(F45, r45)
    U_b1 = saddle.mobility_apply_fn(cfg_45, radii=radii)(F45[0], r45)
    ph45 = dict(n=n45, radii=sorted({round(float(v), 6)
                                     for v in radii.unique()}),
                max_nbr=cfg_45.ewald_nbr_tiles,
                rel_1=op_rel(U_b1, U_cl[0]), rel_2=op_rel(U_b2, U_cl))
    x0_m = torch.cat([s.X for s in states])
    reset_launches(counters)
    gen_m = torch.Generator(device=dev).manual_seed(SEED + 45)
    ss, tr_mw = multi.run_bd_multi(mgeom, cfg_45, states, 1,
                                   force_fn=lambda s_, i: forces,
                                   generator=gen_m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss, tr_m = multi.run_bd_multi(mgeom, cfg_45, ss, BM_TIMED_STEPS,
                                  force_fn=lambda s_, i: forces,
                                  generator=gen_m)
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    res_m = torch.cat([tr_mw["residual"], tr_m["residual"]])
    qn_m = torch.cat([torch.linalg.norm(s.Q, dim=1) for s in ss])
    ph45.update(steps_per_s=BM_TIMED_STEPS / wall_m,
                iters=torch.cat([tr_mw["iters"], tr_m["iters"]]).tolist(),
                residuals=res_m.tolist(), max_residual=res_m.max().item(),
                max_q_dev=(qn_m - 1).abs().max().item(),
                launches=launches(counters))
    print(f"phase 45, the polydisperse periodic mixture ({n45} blobs, L = "
          f"{EW_BOX[0]:g}, rc {BAL_RC}, p {BAL_P}): " + json.dumps(ph45))
    checks = {
        "the operator with radii within the bound of the classic split, "
        "1 and 2 RHS": max(ph45["rel_1"], ph45["rel_2"]) <= BAL_OPERATOR_TOL,
        "max residual < 10 gmres_tol": ph45["max_residual"]
        < 10 * cfg_45.gmres_tol,
        "|q| within 1e-5 of 1": ph45["max_q_dev"] <= 1e-5,
        "bodies moved": (torch.cat([s.X for s in ss]) - x0_m).abs().max()
        .item() > 0,
        "K4 tiles launched": ph45["launches"].get("ewald_real_tiles", 0) > 0,
        "no other kernel launched (K4 has no POLY form)":
            set(ph45["launches"]) == {"ewald_real_tiles"},
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"phase 45 failed: {what}: {ph45}")
    out["phase45"] = ph45
    return out


def band_bench_positions(rng, a):
    """scripts/tpu_farfield_bench.py:37-45's two clouds of 102,400 points:
    the slab above the wall (xy over ±12·√(n/10240), z over [1, 40]) and
    the free cube of side 30 (both physical, a = 0.243553)."""
    n = BAND_BENCH_N
    side = 12.0 * np.sqrt(n / 10240.0)
    slab = rng.uniform([-side, -side, 1.0], [side, side, 40.0], (n, 3))
    cube = rng.uniform(0, BAND_CUBE_L, (n, 3)) * a / 0.243553
    return slab, cube


def band_operator(torch, farfield, profiling, label, r, F2, U_ex, kw):
    """One variant of phases 46 and 48: the far field with ``kw`` (grid, p,
    band_p)
    at positions r, its prepare ms, apply ms at 1 and 2 RHS and their
    far_band part, the lattices' and band blocks' bytes, the peak memory
    above what was held, and max|dU|/max|U| against the exact product."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ctx = farfield.prepare(r, **kw)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    U = farfield.mobility_apply(F2[0], r, ctx=ctx, **kw)
    torch.cuda.synchronize()
    rel = ((U - U_ex).abs().max() / U_ex.abs().max()).item()
    finite = bool(torch.isfinite(U).all())
    del U
    rec = dict(grid=list(kw["grid"]), p=kw["p"], band_p=kw["band_p"],
               prepare_ms=prep_ms, rel=rel,
               lattice_bytes=nbytes(ctx.khat_free, ctx.khat_wall),
               band_bytes=nbytes(ctx.band_free, ctx.band_wall))
    for k in (1, 2):
        Fk = F2[0] if k == 1 else F2
        rec[f"ms_{k}"] = cuda_ms(torch, lambda: farfield.mobility_apply(
            Fk, r, ctx=ctx, **kw), 3)
        with profiling.StepTimer() as timer:
            farfield.mobility_apply(Fk, r, ctx=ctx, **kw)
        split = timer.split()
        rec[f"far_band_ms_{k}"] = split.get("far_band", {}).get("ms", 0.0)
    torch.cuda.synchronize()
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    del ctx
    print(f"{label}: " + json.dumps(rec))
    if not finite:
        raise AssertionError(f"{label}: non-finite product")
    return rec


def band_phases(torch, dev, counters):
    """Phases 46-48: the far field's band tier (farfield_band_p: cell
    offsets 2..3 at a higher order as batched matmuls over the offsets,
    the FFT lattices masked beyond).  Returns the phases' readings."""
    import warnings

    from rigid_body_light_tpu_torch import multi
    from rigid_body_light_tpu_torch.dynamics import (make_draws, run_bd,
                                                     stochastic_step)
    from rigid_body_light_tpu_torch.ops import farfield, rpy_cuda
    from rigid_body_light_tpu_torch.utils import profiling

    out = {}
    rng = np.random.default_rng(SEED + 46)
    # the band's matmuls in full float32: TF32 would cost ~1e-3
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("float32 matmuls are set to TF32")

    # ---- 46. the band operator at the JAX bench's own case
    a = 0.243553
    slab, cube = band_bench_positions(rng, a)
    ph46 = {}
    for label, pos, wall, variants in (
            ("slab above the wall", slab, True,
             [((10, 10, 5), 4, 6), ((10, 10, 5), 4, 0),
              ((10, 10, 5), 6, 0)]),
            (f"free cube L = {BAND_CUBE_L:g}", cube, False,
             [(None, 4, 6), (None, 4, 0)])):
        r = torch.from_numpy(pos).to(dev).float()
        F2 = torch.from_numpy(rng.standard_normal((2, len(pos), 3))).to(
            dev).float()
        U_ex = rpy_cuda.mobility_apply(F2[0], r, a=a, eta=1.0, wall=wall)
        recs = []
        for grid, p, bp in variants:
            grid = grid or farfield.auto_grid(len(pos), p, wall)
            grid = (grid,) * 3 if isinstance(grid, int) else grid
            kw = dict(a=a, eta=1.0, wall=wall, grid=grid, p=p, band_p=bp)
            recs.append(band_operator(
                torch, farfield, profiling,
                f"phase 46, {label}, grid {grid}, p = {p}, band {bp}", r, F2,
                U_ex, kw))
        ratio = recs[1]["rel"] / recs[0]["rel"]
        ph46[label] = dict(n=len(pos), variants=recs, band_gain=ratio)
        print(f"phase 46, {label}: p = 4 + band 6 {recs[0]['rel']:.3e}, "
              f"p = 4 {recs[1]['rel']:.3e}: {ratio:.1f}x tighter (at least "
              f"{BAND_GAIN:g}x)")
        if not ratio >= BAND_GAIN:
            raise AssertionError(f"phase 46, {label}: the band tier is "
                                 f"only {ratio:.2f}x tighter than p = 4")
        del r, F2, U_ex
    out["phase46"] = ph46

    # ---- 47. the far-field slice with the band tier through run_bd
    torch.cuda.empty_cache()
    cfg_f, geom_f, state_f, force_f = farfield_setup(torch, dev, FF_BODIES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg_p4 = cfg_f.replace(gmres_tol=BAND_GMRES_TOL)
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # the estimate must not warn
        cfg_b = cfg_f.replace(gmres_tol=BAND_GMRES_TOL, farfield_band_p=6)
    ph47 = {"gmres_tol": BAND_GMRES_TOL}
    for label, cfg_ in (("p = 4 + band 6", cfg_b), ("p = 4", cfg_p4)):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        reset_launches(counters)
        s, tr_w = run_bd(geom_f, cfg_, state_f, FF_WARM_STEPS, generator=gen,
                         force_fn=lambda s_, i: force_f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, tr = run_bd(geom_f, cfg_, s, FF_TIMED_STEPS, generator=gen,
                       force_fn=lambda s_, i: force_f)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        cnt = launches(counters)
        steps = FF_WARM_STEPS + FF_TIMED_STEPS
        res = torch.cat([tr_w["residual"], tr["residual"]])
        qn = torch.linalg.norm(s.Q, dim=1)
        rec = dict(steps_per_s=FF_TIMED_STEPS / wall_s,
                   iters=torch.cat([tr_w["iters"], tr["iters"]]).tolist(),
                   residuals=res.tolist(), launches=cnt,
                   k3_per_step=cnt.get("near_sweep", 0) / steps,
                   max_q_dev=(qn - 1).abs().max().item())
        print(f"phase 47, the far-field slice at {label} (gmres_tol "
              f"{BAND_GMRES_TOL:g}): " + json.dumps(rec))
        checks = {
            "every residual < 10 gmres_tol": res.max().item()
            < 10 * BAND_GMRES_TOL,
            "state finite": bool(torch.isfinite(s.X).all()),
            "|q| within 1e-5 of 1": rec["max_q_dev"] <= 1e-5,
            "K3 alone launched": set(cnt) == {"near_sweep"},
        }
        for what, ok in checks.items():
            if not ok:
                raise AssertionError(f"phase 47, {label}: {what}: {rec}")
        ph47[label] = rec
        if cfg_ is cfg_b:
            s_b, gen_b = s, gen
    ph47["split"] = step_split(
        torch, profiling, "far-field, band 6",
        lambda k: run_bd(geom_f, cfg_b, s_b, k, generator=gen_b,
                         force_fn=lambda s_, i: force_f), 1)
    # one step through K3 against one through the plain near sweep, from
    # the same draws, at phase 9's 25,620 blobs
    cfg_c, geom_c, state_c, force_c = farfield_setup(torch, dev,
                                                     FF_CHECK_BODIES)
    cfg_cb = cfg_c.replace(gmres_tol=BAND_GMRES_TOL, farfield_band_p=6)
    draws = make_draws(geom_c, state_c,
                       torch.Generator(device=dev).manual_seed(SEED + 47))
    s_k, aux_k = stochastic_step(geom_c, cfg_cb, state_c, force_c,
                                 draws=draws)
    s_p, aux_p = stochastic_step(geom_c, cfg_cb.replace(use_pallas=False),
                                 state_c, force_c, draws=draws)
    torch.cuda.synchronize()
    dX_k, dX_p = s_k.X - state_c.X, s_p.X - state_c.X
    ph47["step_check_rel"] = ((dX_k - dX_p).abs().max()
                              / dX_p.abs().max()).item()
    print(f"phase 47, a band step through K3 against the plain near sweep "
          f"at {FF_CHECK_BODIES} x {FF_SHELL}: max|dX_k - dX_p|/max|dX_p| = "
          f"{ph47['step_check_rel']:.3e} (tol {STEP_TOL:g}); iters "
          f"{aux_k.iters} vs {aux_p.iters}")
    if not (ph47["step_check_rel"] <= STEP_TOL
            and torch.isfinite(s_k.X).all()):
        raise AssertionError(f"phase 47: the band step through K3 "
                             f"disagrees with the plain one: {ph47}")
    out["phase47"] = ph47
    del s_b, s_k, s_p

    # ---- 48. the polydisperse band at the far-field mixture
    torch.cuda.empty_cache()
    cfg_x, mgeom_x, states_x, forces_x = farfield_mixture_setup(
        torch, dev, FF_BODIES)
    opses_x = multi.geometry_ops_multi(mgeom_x, states_x)
    r_x = multi.concat_positions(opses_x)
    rad_x = multi.blob_radii_multi(mgeom_x, opses_x, cfg_x)
    F_x = torch.from_numpy(rng.standard_normal((2, r_x.shape[0], 3))).to(
        dev).float()
    U_ex = rpy_cuda.mobility_apply(F_x[0], r_x, a=cfg_x.a, eta=cfg_x.eta,
                                   wall=True, radii=rad_x)
    ph48 = dict(n=r_x.shape[0])
    for bp in (6, 0):
        kw = dict(a=cfg_x.a, eta=cfg_x.eta, wall=True, grid=FF_GRID, p=FF_P,
                  band_p=bp, radii=rad_x)
        ph48[f"band_{bp}"] = band_operator(
            torch, farfield, profiling,
            f"phase 48, the far-field mixture, band {bp}", r_x, F_x, U_ex,
            kw)
    ph48["band_gain"] = ph48["band_0"]["rel"] / ph48["band_6"]["rel"]
    del U_ex, F_x
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg_xb = cfg_x.replace(gmres_tol=BAND_GMRES_TOL, farfield_band_p=6)
    gen_x = torch.Generator(device=dev).manual_seed(SEED)
    reset_launches(counters)
    s_x, tr_w = multi.run_bd_multi(mgeom_x, cfg_xb, states_x, 1,
                                   generator=gen_x,
                                   force_fn=lambda ss, i: forces_x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_x, tr = multi.run_bd_multi(mgeom_x, cfg_xb, s_x, 1, generator=gen_x,
                                 force_fn=lambda ss, i: forces_x)
    torch.cuda.synchronize()
    wall_x = time.perf_counter() - t0
    res = torch.cat([tr_w["residual"], tr["residual"]])
    ph48.update(steps_per_s=1.0 / wall_x, launches=launches(counters),
                iters=torch.cat([tr_w["iters"], tr["iters"]]).tolist(),
                residuals=res.tolist())
    print(f"phase 48, the far-field mixture with band 6: operator "
          f"{ph48['band_6']['rel']:.3e} against p = 4's "
          f"{ph48['band_0']['rel']:.3e} ({ph48['band_gain']:.1f}x); one "
          f"run_bd_multi step after a warm-up: {ph48['steps_per_s']:.4f} "
          f"steps/s, iters {ph48['iters']}, residuals {ph48['residuals']}, "
          f"launches {ph48['launches']}")
    checks = {
        "the band tighter than p = 4": ph48["band_gain"] > 1.0,
        "every residual < 10 gmres_tol": res.max().item()
        < 10 * BAND_GMRES_TOL,
        "state finite": all(bool(torch.isfinite(s_.X).all()) for s_ in s_x),
        "K3's POLY form alone launched": set(ph48["launches"])
        == {"near_sweep_poly"},
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"phase 48: {what}: {ph48}")
    out["phase48"] = ph48
    return out


def adjoint_phases(torch, dev, counters):
    """Phase 49: the adjoints at the dense slice — K1's autograd Function
    (rpy_cuda.MobilityApply), solvers.make_differentiable_solver and
    dynamics.make_differentiable_step — and the raises of the kernels
    without a backward.  Returns the phase's readings."""
    from rigid_body_light_tpu_torch.dynamics import make_differentiable_step
    from rigid_body_light_tpu_torch.ops import (ewald, ewald_cuda, farfield,
                                                kinematics as kin, rpy,
                                                rpy_cuda, saddle, solvers)
    from rigid_body_light_tpu_torch.state import BodyState

    ph = {}
    rng = np.random.default_rng(SEED + 49)
    cfg, geom, state, force = slice_setup(torch, dev)
    a, eta, h = cfg.a, cfg.eta, cfg.wall_h_floor

    # 49.1 the Function's backward against autograd through the plain
    # float32 sweep, at 4 bodies of the slice
    r4 = kin.blob_positions(geom, state.X[:4], state.Q[:4]).reshape(-1, 3)
    F4 = torch.from_numpy(rng.standard_normal((2, r4.shape[0], 3))).to(
        dev).float()
    grads = []
    for fn in (rpy_cuda.mobility_apply, rpy.mobility_apply):
        rr, FF = r4.clone().requires_grad_(), F4[0].clone().requires_grad_()
        U = fn(FF, rr, a=a, eta=eta, wall=True, h_floor=h)
        grads.append(torch.autograd.grad(U, (FF, rr), F4[1]))
    (gF_k, gr_k), (gF_p, gr_p) = grads
    ph["function_F_bar_rel"] = ((gF_k - gF_p).abs().max()
                                / gF_p.abs().max()).item()
    ph["function_r_bar_rel"] = ((gr_k - gr_p).abs().max()
                                / gr_p.abs().max()).item()
    print(f"phase 49.1, K1's autograd Function at n={r4.shape[0]}: F-bar "
          f"{ph['function_F_bar_rel']:.3e} (tol {KERNEL_TOL:g}), r-bar "
          f"{ph['function_r_bar_rel']:.3e} (tol {ADJ_RBAR_TOL:g}) of max "
          f"from autograd through the plain float32 sweep")
    if not (ph["function_F_bar_rel"] <= KERNEL_TOL
            and ph["function_r_bar_rel"] <= ADJ_RBAR_TOL):
        raise AssertionError(f"phase 49.1: the Function's backward "
                             f"disagrees with the plain path: {ph}")

    # 49.4 at full width: the Function's forward and backward ms, launches
    # and the backward's peak memory (the plain sweep's r-bar recomputes
    # its row tiles)
    r = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3)
    n = r.shape[0]
    F2 = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev).float()
    rr, FF = r.clone().requires_grad_(), F2[0].clone().requires_grad_()
    reset_launches(counters)
    U = rpy_cuda.mobility_apply(FF, rr, a=a, eta=eta, wall=True)
    torch.cuda.synchronize()
    fwd_launches = launches(counters)
    reset_launches(counters)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gF, gr = torch.autograd.grad(U, (FF, rr), F2[1], retain_graph=True)
    torch.cuda.synchronize()
    ph["backward_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    bwd_launches = launches(counters)
    ph["forward_ms"] = cuda_ms(torch, lambda: rpy_cuda.mobility_apply(
        FF, rr, a=a, eta=eta, wall=True), 5)
    ph["backward_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        U, (FF, rr), F2[1], retain_graph=True), 2)
    # the force cotangent alone, on a graph where r needs none
    U_f = rpy_cuda.mobility_apply(FF, r, a=a, eta=eta, wall=True)
    ph["backward_force_only_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        U_f, FF, F2[1], retain_graph=True), 5)
    ph.update(n=n, forward_launches=fwd_launches,
              backward_launches=bwd_launches)
    print(f"phase 49.4, the Function at n={n}: forward {ph['forward_ms']:.3f}"
          f" ms ({fwd_launches}), backward {ph['backward_ms']:.3f} ms "
          f"({bwd_launches}; F-bar alone {ph['backward_force_only_ms']:.3f} "
          f"ms), the backward's peak {ph['backward_peak_bytes'] / 1e9:.3f} "
          f"GB above what was held")
    if not (fwd_launches == {"pair_sweep_sym": 1}
            and bwd_launches == {"pair_sweep_sym": 1}
            and bool(torch.isfinite(gr).all())):
        raise AssertionError(f"phase 49.4: the Function's launches: {ph}")
    del U, U_f, gF, gr, rr, FF

    # 49.2 the symmetry identity: ∂(v·U)/∂F = N·v at full width
    solve = solvers.make_differentiable_solver(cfg)
    ops = saddle.geometry_ops(geom, state)
    slip = torch.zeros_like(ops.flat_positions)
    v = torch.from_numpy(rng.standard_normal((N_BODIES, 6))).to(dev).float()
    Fg = force.clone().requires_grad_()
    reset_launches(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, U_s = solve(ops, slip, Fg)
    torch.cuda.synchronize()
    solve_fwd_ms = (time.perf_counter() - t0) * 1e3
    solve_fwd_launches = launches(counters)
    reset_launches(counters)
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(torch.sum(U_s * v), Fg)
    torch.cuda.synchronize()
    solve_bwd_ms = (time.perf_counter() - t0) * 1e3
    solve_bwd_launches = launches(counters)
    _, Nv = solve(ops, slip, v)
    ph["symmetry_rel"] = ((g - Nv).abs().max() / Nv.abs().max()).item()
    ph.update(solve_forward_ms=solve_fwd_ms, solve_backward_ms=solve_bwd_ms,
              solve_forward_launches=solve_fwd_launches,
              solve_backward_launches=solve_bwd_launches)
    print(f"phase 49.2, the differentiable solve at n={n}: d(v.U)/dF "
          f"against N.v {ph['symmetry_rel']:.3e} (tol "
          f"{10 * cfg.gmres_tol:g}); forward {solve_fwd_ms:.1f} ms "
          f"({solve_fwd_launches}), backward {solve_bwd_ms:.1f} ms "
          f"({solve_bwd_launches})")
    if not ph["symmetry_rel"] <= 10 * cfg.gmres_tol:
        raise AssertionError(f"phase 49.2: the symmetry identity: {ph}")

    # 49.3 a 3-step differentiable trajectory: the loss Σ final heights,
    # its gradient in F and X₀ against central differences
    step = make_differentiable_step(geom, cfg)

    def loss(X0, F):
        s = BodyState(X=X0, Q=state.Q)
        for _ in range(ADJ_STEPS):
            s = step(s, F)
        return torch.sum(s.X[:, 2].double())

    X0 = state.X.clone().requires_grad_()
    Fg = force.clone().requires_grad_()
    reset_launches(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    L = loss(X0, Fg)
    torch.cuda.synchronize()
    traj_fwd_ms = (time.perf_counter() - t0) * 1e3
    traj_fwd_launches = launches(counters)
    reset_launches(counters)
    t0 = time.perf_counter()
    gX, gF = torch.autograd.grad(L, (X0, Fg))
    torch.cuda.synchronize()
    traj_bwd_ms = (time.perf_counter() - t0) * 1e3
    traj_bwd_launches = launches(counters)
    traj_peak = torch.cuda.max_memory_allocated() - base
    dirs = {}
    with torch.no_grad():
        for name, eps, grad, delta in (
                ("F", ADJ_EPS_F, gF, torch.from_numpy(
                    rng.standard_normal((N_BODIES, 6))).to(dev).float()),
                ("X0", ADJ_EPS_X, gX, torch.from_numpy(
                    rng.standard_normal((N_BODIES, 3))).to(dev).float())):
            d = delta / delta.norm()
            if name == "F":
                fd = (loss(state.X, force + eps * d)
                      - loss(state.X, force - eps * d)) / (2 * eps)
            else:
                fd = (loss(state.X + eps * d, force)
                      - loss(state.X - eps * d, force)) / (2 * eps)
            ad = torch.sum(grad.double() * d.double())
            # relative to the largest a unit direction can give, ‖grad‖
            dirs[name] = dict(adjoint=ad.item(), central=fd.item(), eps=eps,
                              grad_norm=grad.norm().item(),
                              rel=abs(ad - fd).item() / grad.norm().item())
    ph.update(trajectory_loss=L.item(), trajectory_forward_ms=traj_fwd_ms,
              trajectory_backward_ms=traj_bwd_ms,
              trajectory_forward_launches=traj_fwd_launches,
              trajectory_backward_launches=traj_bwd_launches,
              trajectory_peak_bytes=traj_peak, directional=dirs)
    print(f"phase 49.3, a {ADJ_STEPS}-step differentiable trajectory at "
          f"n={n}: loss {L.item():.6f}; forward {traj_fwd_ms:.1f} ms "
          f"({traj_fwd_launches}), backward {traj_bwd_ms:.1f} ms "
          f"({traj_bwd_launches}), peak {traj_peak / 1e9:.3f} GB above what "
          f"was held; directional derivatives against central differences "
          f"(tol {ADJ_DIR_TOL:g}): " + json.dumps(dirs))
    if not all(d_["rel"] <= ADJ_DIR_TOL for d_ in dirs.values()):
        raise AssertionError(f"phase 49.3: a directional derivative "
                             f"disagrees: {dirs}")

    # 49.5 a gradient through K2 (or K1 at 2 RHS), K3 or K4 raises
    raised = {}
    rr = r.clone().requires_grad_()
    for name, fn in (
            ("K2", lambda: rpy_cuda.mobility_apply_multi(
                F2, rr, a=a, eta=eta, wall=True)),
            ("K3", lambda: farfield.mobility_apply(
                F2[0], rr, a=a, eta=eta, wall=True, grid=(4, 4, 2), p=3)),
            ("K4", lambda: ewald_cuda.mobility_apply(
                F2[0, :700].clone().requires_grad_(),
                torch.from_numpy(rng.uniform(0, 9.0, (700, 3))).to(
                    dev).float(), ewald.make_params((9.0, 9.0, 9.0), 0.45)))):
        try:
            fn()
            raised[name] = False
        except RuntimeError as e:
            raised[name] = "item 15" in str(e)
    ph["raises"] = raised
    print(f"phase 49.5, a gradient through a kernel without a backward "
          f"raises: {raised}")
    if not all(raised.values()):
        raise AssertionError(f"phase 49.5: a gradient went through a kernel "
                             f"without a backward: {raised}")
    return ph


def slab_bound(rows, cols, k, extra=0, images=1):
    """Bound of one slab of the pair sum: rows [r0, r0 + R) against columns
    [c0, c0 + C) (global ids).  The pairs of the slab's overlap with its
    own rows are unordered pairs the function evaluates once (fields 60
    flop + 30 per RHS and direction, both directions), the rest ordered
    pairs (fields + one direction); ``extra`` flop a field (the POLY form),
    ``images`` fields a pair (the box's (2S+1)²).  Bytes: positions and
    forces read once, the rows' output written once."""
    (r0, R), (c0, C) = rows, cols
    o = max(0, min(r0 + R, c0 + C) - max(r0, c0))
    unordered = o * (o - 1) // 2
    ordered = R * C - o * o
    field = (60 + extra) * images
    flops = unordered * (field + 60 * k * images) + ordered * (
        field + 30 * k * images)
    return bound_ms(flops, 12 * (R + C) + 12 * k * (R + C))


def decompositions(n, d):
    """The slabs of the three decompositions of an n-blob sweep over d
    ranks, as ((rows start, rows), (cols start, cols)) lists in the order
    each rank sums them: the 1-D gather (each rank its rows against all
    columns), the ring in the JAX package's order (rank idx at step s the
    block of rank (idx − s) mod d) and SUMMA on a √d × √d mesh (the row
    block's column blocks, closed by the column group's sum)."""
    n_loc = n // d
    gather = [[((i * n_loc, n_loc), (0, n))] for i in range(d)]
    ring = [[((i * n_loc, n_loc), (((i - s) % d) * n_loc, n_loc))
             for s in range(d)] for i in range(d)]
    q = int(round(d ** 0.5))
    m = n // q
    summa = [[((i * m, m), (j * m, m)) for j in range(q)] for i in range(q)]
    return {"gather": gather, "ring": ring, "summa": summa}


def assemble(torch, rpy_cuda, plan, r_over_a, F, wall, h, box=None,
             shells=0, ahat=None):
    """Run every slab of a decomposition through K2's slab entry and
    assemble the product: each rank's slabs summed in its order."""
    rows_out = []
    for slabs in plan:
        acc = None
        for (r0, R), (c0, C) in slabs:
            part = rpy_cuda.pair_sum_slab(
                r_over_a[r0:r0 + R], r0, r_over_a[c0:c0 + C],
                F[:, c0:c0 + C], wall, col_offset=c0, h_floor=h,
                box_over_a=box, image_shells=shells,
                ahat_rows=None if ahat is None else ahat[r0:r0 + R],
                ahat_cols=None if ahat is None else ahat[c0:c0 + C])
            acc = part if acc is None else acc + part
        rows_out.append(acc)
    return torch.cat(rows_out, dim=1)


def check_slabs(torch, rpy, rpy_cuda, label, r_over_a, F2, h, box=None,
                shells=0, ahat=None, decomps=("gather", "ring", "summa")):
    """Phase 50's check at one set of positions: each decomposition at 1
    and 2 RHS against the float64 plain sweep on the same float32 inputs
    (within KERNEL_TOL of max|U|) and against the single-device product
    (K1 at 1 RHS, K2 at 2; with the box and shells, K1/K2's box forms)."""
    n = r_over_a.shape[0]
    ids = torch.arange(n, device=r_over_a.device)
    ref = rpy.pair_sum(r_over_a.double(), ids, r_over_a.double(), ids,
                       F2.double(), wall=True, h_floor=h, box=box,
                       image_shells=shells,
                       radii_rows=None if ahat is None else ahat.double(),
                       radii_cols=None if ahat is None else ahat.double())
    scale = ref.abs().max().item()
    plans = decompositions(n, DIST_D)
    errs = {}
    for k in (1, 2):
        single = rpy_cuda.pair_sum(r_over_a, F2[0] if k == 1 else F2[:k],
                                   True, h_floor=h, box_over_a=box,
                                   image_shells=shells, ahat=ahat)
        single = single[None] if k == 1 else single
        for name in decomps:
            U = assemble(torch, rpy_cuda, plans[name], r_over_a, F2[:k], True,
                         h, box=box, shells=shells, ahat=ahat)
            torch.cuda.synchronize()
            err = (U.double() - ref[:k]).abs().max().item()
            vs_single = (U - single).abs().max().item() / scale
            print(f"phase 50, {label}, {name} over {DIST_D}, {k} RHS: "
                  f"max|dU|={err:.3e}, /max|U|={err / scale:.3e} (tol "
                  f"{KERNEL_TOL:g}); against the single-device product "
                  f"{vs_single:.3e} of max|U|")
            if not (err / scale <= KERNEL_TOL and torch.isfinite(U).all()):
                raise AssertionError(f"phase 50, {label}, {name}, k={k}: "
                                     f"{err / scale}")
            errs[(name, k)] = dict(err=err, rel=err / scale,
                                   vs_single=vs_single)
    return errs


def slab_times(torch, rpy, rpy_cuda, r_over_a, F2, h):
    """ms a slab launch at 1 and 2 RHS: the ring's n/D × n/D slab, the
    gather's n/D × n slab and the main path's n × n slab at one rank;
    each against the plain float32 sweep of the same slab and its bound."""
    n = r_over_a.shape[0]
    n_loc = n // DIST_D
    shapes = {"ring": ((n_loc, n_loc), (0, n_loc)),    # off the diagonal
              "gather": ((0, n_loc), (0, n)),
              "one_rank": ((0, n), (0, n))}
    out = {}
    for label, ((r0, R), (c0, C)) in shapes.items():
        rows = r_over_a[r0:r0 + R].contiguous()
        cols = r_over_a[c0:c0 + C].contiguous()
        ids_r = torch.arange(r0, r0 + R, device=rows.device)
        ids_c = torch.arange(c0, c0 + C, device=rows.device)
        for k in (1, 2):
            Fk = F2[:k, c0:c0 + C].contiguous()
            ms = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_ordered(
                rows, r0, cols, Fk, c0, True, h), 20)
            plain = cuda_ms(torch, lambda: rpy.pair_sum(
                rows, ids_r, cols, ids_c, Fk, wall=True, h_floor=h), 2)
            b = slab_bound((r0, R), (c0, C), k)
            out[(label, k)] = dict(ms=ms, plain_ms=plain, bound_ms=b[0],
                                   bound_by=b[1], ratio=ms / b[0])
            print(f"phase 50, K2 slab {label} ({R} x {C} at offsets {r0}, "
                  f"{c0}), n={n}, {k} RHS: {ms:.4f} ms "
                  f"a launch, plain float32 {plain:.4f} ms, bound "
                  f"{b[0]:.4f} ms ({b[1]}), {ms / b[0]:.2f}x")
    return out


def slice_kept_pairs(torch, x_ci, live, pairs, count, tile, t0, nt,
                     wrap=None):
    """Kept blob pairs of a K3 work list for the slice of tiles
    [t0, t0 + nt): each listed tile pair's live pairs with cell offset ≤ 1
    on every axis (cyclic in x/y on ``wrap``), i < j on a diagonal tile
    pair — the pairs whose fields the launch evaluates — and how many of
    them lie in a tile pair that crosses the slice's edge (the slice
    needs only their in-slice side)."""
    ci = x_ci
    lane = torch.arange(tile, device=ci.device)
    total = crossing = 0
    rows_all = pairs[:count].long()
    for c0 in range(0, count, 2048):
        pr = rows_all[c0:c0 + 2048]
        a = pr[:, 0:1] * tile + lane
        b = pr[:, 1:2] * tile + lane
        dc = (ci[a][:, :, None, :] - ci[b][:, None, :, :]).abs()
        for ax, g in enumerate(wrap or ()):
            dc[..., ax] = torch.minimum(dc[..., ax], g - dc[..., ax])
        keep = ((dc <= 1).all(dim=-1) & live[a][:, :, None]
                & live[b][:, None, :])
        diag = (pr[:, 0] == pr[:, 1])[:, None, None]
        keep &= ~diag | (lane[:, None] < lane[None, :])
        per_pair = keep.sum(dim=(1, 2))
        a_in = (pr[:, 0] >= t0) & (pr[:, 0] < t0 + nt)
        b_in = (pr[:, 1] >= t0) & (pr[:, 1] < t0 + nt)
        total += int(per_pair.sum())
        crossing += int(per_pair[a_in ^ b_in].sum())
    return total, crossing


def check_slices(torch, farfield, farfield_cuda, label, x, ci, grid, n_real,
                 h, wall=True, ahat=None, box=None, wrap=None,
                 slices=(1, 2, 4), timed=(), extra=0):
    """Phase 51 at one set of positions (x (N, 3) float32 in units of a,
    ci their cells): the sorted tiles as the distributed context builds
    them for D ranks (padded to a multiple of D), every slice of each D
    through K3's slice (float32, 1 and 2 RHS), the concatenated slices'
    real rows against the float64 plain near sweep within KERNEL_TOL and
    against one whole K3 launch; two slice launches bitwise equal; the
    slices' listed pairs and the boundary pairs evaluated twice; at the D
    in ``timed`` each slice's ms against its bound (and at D = 1 the plain
    slice's)."""
    from rigid_body_light_tpu_torch.ops import tiles

    rng = np.random.default_rng(SEED + 51)
    out = {}
    ref = whole = None
    for D in slices:
        _, w, _, t_pad = farfield._resolve_local(
            n_real, wall, grid, FF_P, None, ahat is not None, D)
        order, x_s, ci_s, id_s, ah_s, nbr, overflow = farfield.sorted_tiles(
            x, ci, grid, t_pad, w, ahat=ahat, wrap_xy=wrap)
        if bool(overflow):
            raise AssertionError(f"phase 51, {label}: the neighbor lists "
                                 f"overflow at D = {D}")
        live = id_s >= 0
        full_pairs, full_count = tiles.tile_pairs(nbr)
        if ref is None:
            F = torch.from_numpy(rng.standard_normal((2, n_real, 3))).to(
                x.device).float()
            F_s = torch.zeros((2, x_s.shape[0], 3), device=x.device)
            F_s[:, :n_real] = F[:, order]
            ref = farfield._near_sweep(
                x_s.double(), ci_s, id_s, F_s.double(), nbr, wall, h,
                box_n=box, wrap_xy=wrap,
                ah_s=None if ah_s is None else ah_s.double())[:, :n_real]
            whole = farfield_cuda.near_sweep(
                x_s, ci_s, live, F_s, nbr, wall, h,
                pairs=(full_pairs, full_count), box_over_a=box,
                wrap_cells=wrap, ahat_s=ah_s)[:, :n_real]
        else:
            F_s = torch.zeros((2, x_s.shape[0], 3), device=x.device)
            F_s[:, :n_real] = F[:, order]
        scale = ref.abs().max().item()
        nt = t_pad // D
        lists = [tiles.slice_pairs(full_pairs, full_count, d * nt, nt)
                 for d in range(D)]
        counts = [int(c) for _, c, _ in lists]
        boundary = sum(int(b) for _, _, b in lists) // 2
        rec = dict(t_pad=t_pad, listed_pairs=counts,
                   total_pairs=int(full_count), boundary_pairs=boundary)
        for k in (1, 2):
            Fk = F_s[:k].contiguous()
            parts = []
            for d, (pl, cnt, _) in enumerate(lists):
                args = (x_s, ci_s, live, Fk, nbr, wall, h)
                kw = dict(pairs=(pl, cnt), box_over_a=box, wrap_cells=wrap,
                          ahat_s=ah_s, t0=d * nt, nt=nt)
                U = farfield_cuda.near_sweep(*args, **kw)
                if d == 0 and not torch.equal(
                        U, farfield_cuda.near_sweep(*args, **kw)):
                    raise AssertionError(f"phase 51, {label}: two slice "
                                         f"launches differ, D={D}, k={k}")
                parts.append(U)
            U = torch.cat(parts, dim=1)[:, :n_real]
            torch.cuda.synchronize()
            err = (U.double() - ref[:k]).abs().max().item()
            vs_whole = (U - whole[:k]).abs().max().item() / scale
            print(f"phase 51, {label}, D = {D} ({nt} of {t_pad} tiles a "
                  f"slice, listed pairs {counts}, {boundary} boundary pairs "
                  f"evaluated twice), {k} RHS: max|dU|={err:.3e}, "
                  f"/max|U|={err / scale:.3e} (tol {KERNEL_TOL:g}); against "
                  f"one whole K3 launch {vs_whole:.3e} of max|U|")
            if not (err / scale <= KERNEL_TOL and torch.isfinite(U).all()):
                raise AssertionError(f"phase 51, {label}, D={D}, k={k}: "
                                     f"{err / scale}")
            rec[k] = dict(err=err, rel=err / scale, vs_whole=vs_whole)
            if D in timed:
                rec[k]["slices"] = []
                for d, (pl, cnt, _) in enumerate(lists):
                    args = (x_s, ci_s, live, Fk, nbr, wall, h)
                    kw = dict(pairs=(pl, cnt), box_over_a=box,
                              wrap_cells=wrap, ahat_s=ah_s, t0=d * nt, nt=nt)
                    ms = cuda_ms(torch, lambda: farfield_cuda.near_sweep(
                        *args, **kw), 10)
                    # the plain slice at the main path's D = 1 only: the
                    # whole plain sweep takes seconds
                    plain = (cuda_ms(torch, lambda: farfield._near_sweep(
                        x_s, ci_s, id_s, Fk, nbr, wall, h, box_n=box,
                        wrap_xy=wrap, ah_s=ah_s, t0=d * nt, nt=nt), 1)
                        if D == 1 else None)
                    kept, crossing = slice_kept_pairs(
                        torch, ci_s, live, pl, int(cnt), farfield.TILE,
                        d * nt, nt, wrap)
                    # what the slice needs: a pair's fields and both
                    # sides inside it, the in-slice side alone across its
                    # edge (the kernel applies the other there too, and
                    # drops it)
                    flops = (kept * (60 + extra + 60 * k)
                             - crossing * 30 * k)
                    n_bytes = (x_s.shape[0] * (12 + 12 + 1 + 12 * k)
                               + nt * farfield.TILE * 12 * k
                               + 4 * nbr.numel())
                    b = bound_ms(flops, n_bytes)
                    rec[k]["slices"].append(dict(
                        ms=ms, plain_ms=plain, kept_pairs=kept,
                        kept_crossing=crossing,
                        bound_ms=b[0], bound_by=b[1], ratio=ms / b[0]))
                    print(f"phase 51, {label}, D = {D}, slice {d}, {k} RHS: "
                          f"{ms:.4f} ms, plain float32 {plain} ms, "
                          f"{kept} kept pairs ({crossing} across its "
                          f"edge), bound {b[0]:.4f} ms "
                          f"({b[1]}), {ms / b[0]:.2f}x")
        out[D] = rec
    return out


def far_rows_check(torch, parallel, rpy_cuda, kin, label, cfg, geom,
                   state, group):
    """Phase 52: the distributed far-field operator on the process group
    (its one rank's rows, :func:`parallel.farfield_mobility_apply_local_fn`)
    against rows [0, DIST_EXACT_ROWS) of the exact operator streamed
    through K2's slab (``rpy_cuda.mobility_apply_rows``), max|dU|/max|U|
    over those rows within FF_OPERATOR_TOL."""
    r = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3)
    F = torch.from_numpy(np.random.default_rng(SEED + 52).standard_normal(
        tuple(r.shape))).to(device=r.device, dtype=r.dtype)
    U = parallel.farfield_mobility_apply_local_fn(cfg, group)(F, r)
    U = U[:DIST_EXACT_ROWS]
    U_ex = rpy_cuda.mobility_apply_rows(F, r, 0, DIST_EXACT_ROWS, a=cfg.a,
                                        eta=cfg.eta, wall=cfg.wall,
                                        h_floor=cfg.wall_h_floor)
    torch.cuda.synchronize()
    rel = (U - U_ex).abs().max().item() / U_ex.abs().max().item()
    print(f"phase 52, {label}: the distributed operator against rows "
          f"[0, {DIST_EXACT_ROWS}) of the exact operator (K2's slab): "
          f"max|dU|/max|U| = {rel:.3e} (tol {FF_OPERATOR_TOL:g})")
    if not (rel <= FF_OPERATOR_TOL and bool(torch.isfinite(U).all())):
        raise AssertionError(f"phase 52, {label}: the distributed operator "
                             f"against the exact rows: {rel}")
    return rel


def init_process_group(torch):
    """A process group of this one process on the card (NCCL), its
    address on localhost at a free port."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))


def step_pair(torch, stepper, parallel, geom, cfg, mesh, state, force, seed,
              deterministic=False):
    """One single-device step and one distributed step (world size 1) from
    the same draws: the max |ΔX| difference over max|ΔX|, the Q
    difference, both GMRES iterations and residuals."""
    gen = torch.Generator(device=state.X.device).manual_seed(seed)
    draws = stepper.make_draws(geom, state, gen, cfg)
    if deterministic:
        s1, a1 = stepper.deterministic_step(geom, cfg, state, force)
    else:
        s1, a1 = stepper.stochastic_step(geom, cfg, state, force, draws=draws)
    step = parallel.make_distributed_step(geom, cfg, mesh,
                                          deterministic=deterministic)
    s2, a2 = step(state, force, draws=None if deterministic else draws)
    torch.cuda.synchronize()
    dx = (s1.X - state.X).abs().max().item()
    rel = (s2.X - s1.X).abs().max().item() / dx
    dq = (s2.Q - s1.Q).abs().max().item()
    return dict(rel_dx=rel, max_dx=dx, dq=dq, iters=(a1.iters, a2.iters),
                residuals=(a1.residual.item(), a2.residual.item()))


def distributed_phases(torch, dev, counters):
    """Phases 50-54: distribution (ROADMAP item 16's first slice).  K2's
    slab entries and K3's row-tile slice at full width in this process;
    the distributed stepper on a real process group (NCCL, world size 1);
    the run driver with a "mesh" key through torch.distributed.run.
    Returns the phases' readings."""
    import warnings

    import torch.distributed as dist

    from rigid_body_light_tpu_torch import parallel
    from rigid_body_light_tpu_torch.dynamics import run_bd
    from rigid_body_light_tpu_torch.dynamics import stepper
    from rigid_body_light_tpu_torch.ops import (farfield, farfield_cuda,
                                                kinematics as kin, rpy,
                                                rpy_cuda)
    from rigid_body_light_tpu_torch.utils import profiling

    out = {}
    rng = np.random.default_rng(SEED + 50)
    h = 0.75

    # ---- 50. K2's slab entries at the dense slice, D = 4
    t50 = time.perf_counter()
    cfg, geom, state, force = slice_setup(torch, dev)
    r = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3)
    n = r.shape[0]
    r_a = (r / cfg.a).float().contiguous()
    F2 = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev).float()
    ph50 = {"dense": check_slabs(torch, rpy, rpy_cuda, "dense slice", r_a,
                                 F2, h)}
    ph50["times"] = slab_times(torch, rpy, rpy_cuda, r_a, F2, h)
    cfg_film, geom_film, state_film, _ = film_setup(torch, dev, FILM_SHELLS)
    r_film = kin.blob_positions(geom_film, state_film.X,
                                state_film.Q).reshape(-1, 3)
    box_a = tuple(float(np.float32(b / cfg_film.a)) for b in cfg_film.box)
    ph50["film ring, S = 2"] = check_slabs(
        torch, rpy, rpy_cuda, f"film ring (box {cfg_film.box}, S = "
        f"{FILM_SHELLS})", (r_film / cfg_film.a).float().contiguous(), F2,
        h, box=box_a, shells=FILM_SHELLS, decomps=("ring",))
    cfg_m, mgeom, states_m, _ = mixture_setup(torch, dev)
    r_m = torch.cat([kin.blob_positions(g, s.X, s.Q).reshape(-1, 3)
                     for g, s in zip(mgeom.geoms, states_m)])
    radii = torch.cat([torch.full((s.X.shape[0] * g.n_blobs,),
                                  float(a_s or cfg_m.a), device=dev)
                       for g, s, a_s in zip(mgeom.geoms, states_m,
                                            mgeom.radii)])
    Fm = torch.from_numpy(rng.standard_normal((2, r_m.shape[0], 3))).to(
        dev).float()
    ph50["mixture POLY ring"] = check_slabs(
        torch, rpy, rpy_cuda, f"mixture ring (POLY, n={r_m.shape[0]})",
        (r_m / cfg_m.a).float().contiguous(), Fm, h,
        ahat=(radii / cfg_m.a).float().contiguous(), decomps=("ring",))
    ph50["seconds"] = time.perf_counter() - t50
    out["phase50"] = ph50
    del F2, Fm, r_film, r_m
    torch.cuda.empty_cache()

    # ---- 51. K3's row-tile slice at the far-field slice, D = 1, 2, 4
    t51 = time.perf_counter()
    cfg_f, geom_f, state_f, force_f = farfield_setup(torch, dev, FF_BODIES)
    r_f = kin.blob_positions(geom_f, state_f.X, state_f.Q).reshape(-1, 3)
    x_f = (r_f / cfg_f.a).float()
    lo, hgrid = farfield._grid_geometry(x_f, FF_GRID)
    ci_f, _ = farfield._cell_indices(x_f, lo, hgrid, FF_GRID)
    ph51 = {"far-field slice": check_slices(
        torch, farfield, farfield_cuda, f"far-field slice (n={x_f.shape[0]})",
        x_f, ci_f, FF_GRID, x_f.shape[0], h, timed=(1, 4))}
    cfg_fm, mgeom_fm, states_fm, _ = farfield_mixture_setup(
        torch, dev, FF_BODIES)
    r_fm = torch.cat([kin.blob_positions(g, s.X, s.Q).reshape(-1, 3)
                      for g, s in zip(mgeom_fm.geoms, states_fm)])
    a_fm = torch.cat([torch.full((s.X.shape[0] * g.n_blobs,),
                                 float(a_s or cfg_fm.a), device=dev)
                      for g, s, a_s in zip(mgeom_fm.geoms, states_fm,
                                           mgeom_fm.radii)])
    x_fm = (r_fm / cfg_fm.a).float()
    lo, hgrid = farfield._grid_geometry(x_fm, FF_GRID)
    ci_fm, _ = farfield._cell_indices(x_fm, lo, hgrid, FF_GRID)
    ph51["far-field mixture POLY"] = check_slices(
        torch, farfield, farfield_cuda,
        f"far-field mixture POLY (n={x_fm.shape[0]})", x_fm, ci_fm, FF_GRID,
        x_fm.shape[0], h, ahat=(a_fm / cfg_fm.a).float(), slices=(4,))
    cfg_b, geom_b, state_b, _ = farfield_setup(
        torch, dev, FF_CHECK_BODIES, side=FB_CHECK_SIDE, box=FB_CHECK_BOX,
        grid=FB_CHECK_GRID)
    r_b = kin.blob_positions(geom_b, state_b.X, state_b.Q).reshape(-1, 3)
    box_b = tuple(float(np.float32(b / cfg_b.a)) for b in FB_CHECK_BOX)
    x_b = farfield._wrap_box((r_b / cfg_b.a).float(), box_b)
    lo, hgrid = farfield._geometry_2p(x_b, FB_CHECK_GRID, box_b)
    ci_b, _ = farfield._cell_indices(x_b, lo, hgrid, FB_CHECK_GRID)
    ph51["far-field film check set (box)"] = check_slices(
        torch, farfield, farfield_cuda,
        f"far-field film check set (box {FB_CHECK_BOX}, n={x_b.shape[0]})",
        x_b, ci_b, FB_CHECK_GRID, x_b.shape[0], h, box=box_b,
        wrap=FB_CHECK_GRID[:2], slices=(4,))
    ph51["seconds"] = time.perf_counter() - t51
    out["phase51"] = ph51
    torch.cuda.empty_cache()

    # ---- 52. the distributed stepper on a real process group
    t52 = time.perf_counter()
    init_process_group(torch)
    try:
        mesh = parallel.make_mesh(1)
        ph52 = {"group": {"backend": dist.get_backend(),
                          "world_size": dist.get_world_size()}}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            cfg_band = cfg_f.replace(gmres_tol=BAND_GMRES_TOL,
                                     farfield_band_p=6)
        slices_ = (("dense", cfg, geom, state, force, DIST_TIMED_STEPS),
                   ("far field p = 4", cfg_f, geom_f, state_f, force_f,
                    FF_TIMED_STEPS),
                   ("far field band 6", cfg_band, geom_f, state_f, force_f,
                    FF_TIMED_STEPS))
        for label, cfg_, geom_, st_, f_, timed in slices_:
            rec = {}
            for mode in ("deterministic", "stochastic"):
                p = step_pair(torch, stepper, parallel, geom_, cfg_, mesh,
                              st_, f_, SEED + 52,
                              deterministic=mode == "deterministic")
                rec[mode] = p
                print(f"phase 52, {label}, {mode} step: distributed against "
                      f"single-device {p['rel_dx']:.3e} of max|dX| (tol "
                      f"{STEP_TOL:g}), |dQ| {p['dq']:.3e}, GMRES {p['iters']}"
                      f", residuals {p['residuals']}")
                ok = (p["rel_dx"] <= STEP_TOL
                      and abs(p["iters"][0] - p["iters"][1]) <= 1
                      and max(p["residuals"]) < 10 * cfg_.gmres_tol)
                if not ok:
                    raise AssertionError(f"phase 52, {label}, {mode}: {p}")
            if label != "dense":
                rec["vs_exact_rows"] = far_rows_check(
                    torch, parallel, rpy_cuda, kin, label, cfg_, geom_, st_,
                    parallel.mesh_group(mesh))
            run_d = parallel.make_distributed_run_bd(
                geom_, cfg_, mesh, DIST_WARM_STEPS, force_fn=lambda s, i: f_)
            run_t = parallel.make_distributed_run_bd(
                geom_, cfg_, mesh, timed, force_fn=lambda s, i: f_)
            rates = {}
            for which in ("run_bd", "distributed", "distributed", "run_bd"):
                gen = torch.Generator(device=dev).manual_seed(SEED)
                if which == "run_bd":
                    s_, _ = run_bd(geom_, cfg_, st_, DIST_WARM_STEPS,
                                   generator=gen, force_fn=lambda s, i: f_)
                    torch.cuda.synchronize()
                    reset_launches(counters)
                    t0 = time.perf_counter()
                    s_, tr = run_bd(geom_, cfg_, s_, timed, generator=gen,
                                    force_fn=lambda s, i: f_)
                else:
                    s_, _ = run_d(st_, generator=gen)
                    torch.cuda.synchronize()
                    reset_launches(counters)
                    t0 = time.perf_counter()
                    s_, tr = run_t(s_, generator=gen)
                torch.cuda.synchronize()
                rates.setdefault(which, []).append(
                    timed / (time.perf_counter() - t0))
                cnt = launches(counters)
                res = tr["residual"].max().item()
                if not (res < 10 * cfg_.gmres_tol
                        and bool(torch.isfinite(s_.X).all())):
                    raise AssertionError(f"phase 52, {label}, {which}: "
                                         f"residual {res}")
                rec[f"{which} launches"] = cnt
                rec[f"{which} iters"] = tr["iters"].tolist()
            rec["steps_per_s"] = rates
            per_step = {k: v / timed for k, v in
                        rec["distributed launches"].items()}
            rec["distributed launches per step"] = per_step
            print(f"phase 52, {label}: make_distributed_run_bd "
                  f"{rates['distributed']} steps/s, run_bd {rates['run_bd']} "
                  f"(in turns); distributed launches a step {per_step}; "
                  f"run_bd's {rec['run_bd launches']}")
            want = "pair_sweep_slab" if label == "dense" else \
                "near_sweep_slice"
            if not per_step.get(want):
                raise AssertionError(f"phase 52, {label}: the distributed "
                                     f"run launched no {want}: {per_step}")
            for key in ("pair_sweep_sym", "pair_sweep_ordered", "near_sweep"):
                if per_step.get(key):
                    raise AssertionError(f"phase 52, {label}: the "
                                         f"distributed run launched the "
                                         f"single-device {key}")
            rec["split"] = step_split(
                torch, profiling, f"{label} distributed",
                lambda n_: parallel.make_distributed_run_bd(
                    geom_, cfg_, mesh, n_, force_fn=lambda s, i: f_)(
                    st_, generator=torch.Generator(device=dev).manual_seed(
                        SEED)), 1)
            ph52[label] = rec
        # the gather mode: the sharded mobility product through run_bd
        mob = parallel.sharded_mobility_apply_fn(cfg, mesh)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        run_bd(geom, cfg, state, DIST_WARM_STEPS, generator=gen,
               force_fn=lambda s, i: force, mob_apply=mob)
        torch.cuda.synchronize()
        reset_launches(counters)
        t0 = time.perf_counter()
        s_, tr = run_bd(geom, cfg, state, DIST_TIMED_STEPS, generator=gen,
                        force_fn=lambda s, i: force, mob_apply=mob)
        torch.cuda.synchronize()
        cnt = launches(counters)
        rec = dict(steps_per_s=DIST_TIMED_STEPS / (time.perf_counter() - t0),
                   launches=cnt, iters=tr["iters"].tolist(),
                   max_residual=tr["residual"].max().item())
        print(f"phase 52, gather mode (sharded_mobility_apply_fn) through "
              f"run_bd at the dense slice: " + json.dumps(rec))
        if not (cnt.get("pair_sweep_slab") and rec["max_residual"]
                < 10 * cfg.gmres_tol and bool(torch.isfinite(s_.X).all())):
            raise AssertionError(f"phase 52, gather mode: {rec}")
        ph52["gather mode"] = rec
    finally:
        dist.destroy_process_group()
    ph52["seconds"] = time.perf_counter() - t52
    out["phase52"] = ph52

    # ---- 53. D = 4 NCCL ranks on the one card: not run (NCCL refuses
    # four ranks on one GPU; phase 57 runs D = 4 through gloo ranks)
    print("phase 53: not run: NCCL refuses four ranks on one card "
          "('Duplicate GPU detected'); phase 57 runs D = 4 on the card "
          "through gloo ranks")

    # ---- 54. the run driver with a "mesh" key
    t54 = time.perf_counter()
    out["phase54"] = driver_mesh_phase()
    out["phase54"]["seconds"] = time.perf_counter() - t54
    return out


def driver_mesh_phase():
    """Phase 54: examples/distributed_suspension.json with mesh shape [1],
    mode "distributed", 10 steps (a frame and a checkpoint every 5),
    through python -m torch.distributed.run --nproc_per_node 1 (NCCL), then
    resumed for 10 more: the frames and the checkpoint rank 0 wrote, the
    steps without a gap, every residual below 10·gmres_tol."""
    from rigid_body_light_tpu_torch.runtime import read_trajectory
    from rigid_body_light_tpu_torch.utils.checkpoint import load_checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples",
                           "distributed_suspension.json")) as f:
        conf = json.load(f)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        conf.update(n_steps=DRIVER_MESH_STEPS, save_every=5,
                    checkpoint_every=5, output_dir=os.path.join(tmp, "out"),
                    mesh={"shape": [1], "mode": "distributed"})
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        env = dict(os.environ, PYTHONPATH=here)
        base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m",
                "rigid_body_light_tpu_torch.run", path]
        ckpt = os.path.join(conf["output_dir"], "checkpoint.npz")
        lines, times = [], []
        for argv in (base, base + ["--resume", ckpt]):
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=here, env=env,
                                  capture_output=True, text=True,
                                  timeout=300)
            times.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise AssertionError(f"phase 54: {' '.join(argv[2:])} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-3000:]}")
            lines.append([json.loads(ln) for ln in proc.stdout.splitlines()
                          if ln.startswith("{")])
        steps, _, X, Q = read_trajectory(os.path.join(conf["output_dir"],
                                                      "trajectory.rblt"))
        _, _, step, meta = load_checkpoint(ckpt, device="cuda")
        chunks = [ln for run in lines for ln in run if "step" in ln]
        rec = dict(first_line=lines[0][0], steps=steps.tolist(),
                   checkpoint_step=step, launch_s=times,
                   steps_per_s=[ln["steps_per_sec"] for ln in chunks],
                   max_residual=max(ln["max_residual"] for ln in chunks),
                   rank_generator_states=len(meta["rank_generator_states"]))
        print("phase 54, the run driver with a mesh key through "
              "torch.distributed.run: " + json.dumps(rec))
        want = list(range(5, 2 * DRIVER_MESH_STEPS + 1, 5))
        checks = {
            "first line": rec["first_line"] == {"mesh": {"blobs": 1},
                                                "mode": "distributed"},
            "frames without a gap": rec["steps"] == want,
            "checkpoint at the end": step == 2 * DRIVER_MESH_STEPS,
            "finite": bool(np.isfinite(X).all() and np.isfinite(Q).all()),
            "residuals": rec["max_residual"]
            < 10 * conf["solver"]["gmres_tol"],
        }
        for what, ok in checks.items():
            if not ok:
                raise AssertionError(f"phase 54: {what}: {rec}")
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ewald_slab_bound(rows, cols, k, deg):
    """Bound of one K4 slab: rows [r0, r0 + R) against columns [c0, c0 + C)
    (global ids).  The pairs of its overlap with its own rows are
    unordered pairs the function evaluates once, at K4's 36 + 6·D + 36 per
    RHS (fields, two Clenshaw chains of degree D, both directions); the
    rest ordered pairs at 36 + 6·D + 18 per RHS (one direction).  Bytes:
    positions and the columns' forces read once, the rows' output written
    once, the coefficient table."""
    (r0, R), (c0, C) = rows, cols
    o = max(0, min(r0 + R, c0 + C) - max(r0, c0))
    fields = 36 + 6 * deg
    flops = (o * (o - 1) // 2 * (fields + 36 * k)
             + (R * C - o * o) * (fields + 18 * k))
    return bound_ms(flops, 12 * (R + C) + 12 * k * (R + C) + 32 * (deg + 1))


def ptxas_lines(kernel):
    """The ptxas report (registers, spills) of each instantiation of
    ``kernel`` from this run's build (BUILD_LOGS), or [] where the library
    was built before this run."""
    out = []
    for log in BUILD_LOGS.values():
        lines = log.splitlines()
        for idx, line in enumerate(lines):
            if "Compiling entry function" in line and kernel in line:
                name = line.split("'")[1] if "'" in line else line
                out.append(name + ": " + " | ".join(
                    x.split(":", 1)[-1].strip() for x in lines[idx + 1:idx + 4]
                    if "registers" in x or "spill" in x))
    return out


def ewald_slab_phase(torch, dev):
    """Phase 55: K4's slab form at the periodic slice's 10,272 positions in
    L = 14, split over D ranks in this process as the ring sweeps it
    (ewald.ring_slab: each rank's diagonal block through K4's symmetric
    sweep, the others through the slab form), D = DIST_D and 2: each
    rank's ring sum at 1 and 2 RHS against the float64 Clenshaw sweep, the
    diagonal blocks bitwise K4's sweep of the block, the slab at the n × n
    overlap (its self pairs masked) against float64 too, two launches
    bitwise equal, the slab kernel's ptxas registers and spills, and each
    slab shape's ms beside its bound and the plain block's (the rings'
    n/D × n/D at D = DIST_D and 2, the gather's n/4 × n, one rank's
    n × n)."""
    from rigid_body_light_tpu_torch.ops import ewald, ewald_cuda, saddle
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    cfg, geom, state = ewald_setup(torch, dev)
    params = saddle._ewald_params(*saddle._ewald_params_key(cfg))
    deg = ewald_cuda.operator_tables(params, dev)[2]
    r = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3).float()
    r = r.contiguous()
    n = r.shape[0]
    n_l = n // DIST_D
    rng = np.random.default_rng(SEED + 55)
    F2 = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev).float()
    ref = ewald.real_space_apply(F2.double(), r.double(), params, cheb=True)
    scale = ref.abs().max().item()
    out = {"n": n, "degree": deg, "ring": {}, "ring_d2": {},
           "ptxas": ptxas_lines("ewald_slab_kernel")}
    for line in out["ptxas"] or ["not in this run's build log (built "
                                 "before)"]:
        print(f"phase 55, ewald_slab_kernel ptxas: {line}")

    def ring_err(D, k):
        """The largest error of a rank's ring sum over D ranks, checking
        each diagonal block against K4's sweep."""
        m = n // D
        errs = []
        for idx in range(D):
            rows = slice(idx * m, (idx + 1) * m)
            acc = None
            for s in range(D):
                src = (idx - s) % D
                cols = slice(src * m, (src + 1) * m)
                part = ewald.ring_slab(
                    F2[:k, cols].contiguous(), r[rows], idx * m, r[cols],
                    src * m, params, use_kernel=True, diagonal=s == 0)
                if s == 0 and not torch.equal(part, ewald_cuda.
                                              real_sweep_kernel(
                                                  r[rows].contiguous(),
                                                  F2[:k, rows].contiguous(),
                                                  params)):
                    raise AssertionError(f"phase 55: rank {idx}'s diagonal "
                                         f"block is not K4's sweep, D={D}, "
                                         f"k={k}")
                acc = part if acc is None else acc + part
            torch.cuda.synchronize()
            errs.append((acc.double() - ref[:k, rows]).abs().max().item())
        return max(errs)

    for k in (1, 2):
        err4, err2 = ring_err(DIST_D, k), ring_err(2, k)
        whole = ewald_cuda.real_pair_sum_slab(F2[:k], r, 0, r, 0, params)
        again = ewald_cuda.real_pair_sum_slab(F2[:k], r, 0, r, 0, params)
        torch.cuda.synchronize()
        err_whole = (whole.double() - ref[:k]).abs().max().item()
        rec = dict(err=err4, rel=err4 / scale,
                   err_n_by_n=err_whole, rel_n_by_n=err_whole / scale,
                   repeat_bitwise=bool(torch.equal(whole, again)))
        out["ring"][k] = rec
        out["ring_d2"][k] = dict(err=err2, rel=err2 / scale)
        print(f"phase 55, K4 slab form at the periodic slice (n={n}, "
              f"degree {deg}), {k} RHS: the ring over {DIST_D} ranks "
              f"{rec['rel']:.3e} of max|U| from float64 (tol "
              f"{KERNEL_TOL:g}), over 2 ranks {err2 / scale:.3e}, the n x n "
              f"slab {rec['rel_n_by_n']:.3e}, two launches bitwise equal: "
              f"{rec['repeat_bitwise']}; the diagonal blocks bitwise K4's "
              f"sweep")
        if not (rec["rel"] <= KERNEL_TOL and err2 / scale <= KERNEL_TOL
                and rec["rel_n_by_n"] <= KERNEL_TOL
                and rec["repeat_bitwise"] and torch.isfinite(whole).all()):
            raise AssertionError(f"phase 55, k={k}: {rec}, D = 2 {err2}")
    shapes = {"one_rank": ((0, n), (0, n)), "gather": ((0, n_l), (0, n)),
              "ring": ((n_l, n_l), (0, n_l)),
              "ring_d2": ((n // 2, n // 2), (0, n // 2))}
    out["times"] = {}
    for label, ((r0, R), (c0, C)) in shapes.items():
        rows = r[r0:r0 + R].contiguous()
        cols = r[c0:c0 + C].contiguous()
        for k in (1, 2):
            Fk = F2[:k, c0:c0 + C].contiguous()
            ms = cuda_ms(torch, lambda: ewald_cuda.real_slab_kernel(
                rows, r0, cols, c0, Fk, params), 20)
            plain = cuda_ms(torch, lambda: ewald.real_space_block(
                rows, torch.arange(r0, r0 + R, device=dev), cols,
                torch.arange(c0, c0 + C, device=dev), Fk, params), 1)
            b = ewald_slab_bound((r0, R), (c0, C), k, deg)
            out["times"][(label, k)] = dict(ms=ms, plain_ms=plain,
                                            bound_ms=b[0], bound_by=b[1],
                                            ratio=ms / b[0])
            print(f"phase 55, K4 slab {label} ({R} x {C} at offsets {r0}, "
                  f"{c0}), {k} RHS: {ms:.4f} ms a launch, plain float32 "
                  f"{plain:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
                  f"{ms / b[0]:.2f}x")
    return out


def tile_slice_phase(torch, dev):
    """Phase 56: the balanced split's tile sweep at phase 44's 115,560
    blobs in L = 30, its sorted tiles padded for 1, 2 and 4 ranks and each
    rank's slice swept in this process (K4 tiles,
    ewald_cuda.tile_pair_sum at t0, nt): the slices' union bitwise the
    one-device sweep, with each decomposition's slice times."""
    from rigid_body_light_tpu_torch.ops import ewald_cells, ewald_cuda, saddle
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    cfg, geom, state = balanced_split_setup(torch, dev)
    params = saddle._ewald_params(*saddle._ewald_params_key(cfg))
    r = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3).float()
    n = r.shape[0]
    rng = np.random.default_rng(SEED + 56)
    F = torch.from_numpy(rng.standard_normal((1, n, 3))).to(dev).float()
    rf = ewald_cells._fold(r, params)
    out = {"n": n}
    whole = None
    for d in (1, 2, 4):
        order, r_pad, ids_pad, F_pad, pp, nbr, overflow = \
            ewald_cells.sorted_tiles(rf, F, params, nbr_tiles(ewald_cells, r),
                                     d)
        nt = nbr.shape[0] // d
        parts, ms = [], []
        for i in range(d):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts.append(ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr,
                                                  params, poly=pp, t0=i * nt,
                                                  nt=nt))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        U = torch.cat(parts, dim=1)[:, :n]
        if whole is None:
            whole = U
        same = bool(torch.equal(U, whole)) and not bool(overflow)
        out[d] = dict(tiles=int(nbr.shape[0]), slice_ms=ms, bitwise=same)
        print(f"phase 56, the tile sweep at n={n} over {d} rank(s): "
              f"{nbr.shape[0]} tiles, {nt} a slice, slices "
              f"{[round(m, 1) for m in ms]} ms; the union bitwise the "
              f"one-device sweep: {same}")
        if not same:
            raise AssertionError(f"phase 56, D={d}: the slices' union "
                                 f"differs from the whole sweep")
    return out


def step_pair_multi(torch, multi, parallel, mgeom, cfg, mesh, states,
                    forces, seed):
    """phase 57's mixture form of step_pair: one single-device mixture step
    and one distributed mixture step (world size 1) from the same draws."""
    gen = torch.Generator(device=states[0].X.device).manual_seed(seed)
    draws = multi.make_draws_multi(mgeom, states, gen, cfg)
    s1, r1 = multi.stochastic_step_multi(mgeom, cfg, states, forces,
                                         draws=draws)
    s2, r2 = parallel.make_distributed_step_multi(mgeom, cfg, mesh)(
        states, forces, draws=draws)
    torch.cuda.synchronize()
    dX1 = torch.cat([a.X - b.X for a, b in zip(s1, states)])
    dx = dX1.abs().max().item()
    rel = max((a.X - b.X).abs().max().item() for a, b in zip(s2, s1)) / dx
    dq = max((a.Q - b.Q).abs().max().item() for a, b in zip(s2, s1))
    return dict(rel_dx=rel, max_dx=dx, dq=dq, iters=(r1.iters, r2.iters),
                residuals=(r1.residual.item(), r2.residual.item()))


def in_turns(torch, counters, label, runs, timed):
    """steps/s of each of ``runs`` ({name: (warm(), timed())}) in turns A B
    B A, one warm-up each; the launch counts of each name's last timed
    run."""
    names = list(runs)
    rates, counts = {}, {}
    for name in names + names[::-1]:
        warm, run = runs[name]
        warm()
        torch.cuda.synchronize()
        reset_launches(counters)
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        rates.setdefault(name, []).append(timed / (time.perf_counter() - t0))
        counts[name] = launches(counters)
        if not bool(torch.isfinite(res).all()):
            raise AssertionError(f"phase 57, {label}, {name}: not finite")
    print(f"phase 57, {label}: steps/s in turns {rates}; launches "
          f"{counts}")
    return rates, counts


def gloo_card_rank(rank, world, path):
    """A rank of phase 57's D = 4 on one card: gloo ranks sharing cuda:0
    (the ring's blocks staged through the host), the periodic slice's
    distributed step from this rank's draws, rank 0 also the single-device
    step from every rank's draws; then 1 + DIST4_TIMED_STEPS distributed
    steps with their launch counts.  Writes its readings to path."""
    import datetime

    import torch
    import torch.distributed as dist

    from rigid_body_light_tpu_torch import parallel
    from rigid_body_light_tpu_torch.dynamics import stepper
    from rigid_body_light_tpu_torch.ops import ewald_cuda, rpy_cuda
    from rigid_body_light_tpu_torch.state import BodyState
    from rigid_body_light_tpu_torch.utils import collectives

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    store = dist.FileStore(os.path.join(path, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        cfg, geom, state = ewald_setup(torch, dev)
        B = state.X.shape[0]
        b = B // world
        force = torch.zeros((B, 6), dtype=torch.float32, device=dev)
        mesh = parallel.make_mesh(world)
        group = parallel.mesh_group(mesh)
        s_l = BodyState(X=state.X[rank * b:(rank + 1) * b],
                        Q=state.Q[rank * b:(rank + 1) * b])
        gen = torch.Generator(device=dev).manual_seed(SEED + 57 + rank)
        draws = stepper.make_draws(geom, s_l, gen, cfg)
        step = parallel.make_distributed_step(geom, cfg, mesh)
        ewald_cuda.reset_launch_counts()
        rpy_cuda.reset_launch_counts()
        s2, a2 = step(state, force, draws=draws)
        torch.cuda.synchronize()
        rec = {"step_launches": {**ewald_cuda.launch_counts(),
                                 **rpy_cuda.launch_counts()},
               "iters": a2.iters}
        all_draws = [collectives.all_gather(w, group) for w in draws]
        if rank == 0:
            s1, a1 = stepper.stochastic_step(geom, cfg, state, force,
                                             draws=all_draws)
            torch.cuda.synchronize()
            dx = (s1.X - state.X).abs().max().item()
            rec.update(rel_dx=(s2.X - s1.X).abs().max().item() / dx,
                       dq=(s2.Q - s1.Q).abs().max().item(),
                       iters_single=a1.iters)
        run = parallel.make_distributed_run_bd(
            geom, cfg, mesh, DIST4_TIMED_STEPS,
            force_fn=lambda s, i: force[:b])
        run(state, generator=gen)
        torch.cuda.synchronize()
        dist.barrier()
        ewald_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        s3, tr = run(state, generator=gen)
        torch.cuda.synchronize()
        rec.update(steps_per_s=DIST4_TIMED_STEPS / (time.perf_counter() - t0),
                   run_launches=ewald_cuda.launch_counts(),
                   max_residual=tr["residual"].max().item(),
                   finite=bool(torch.isfinite(s3.X).all()))
        with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def gloo_card_phase(torch):
    """Phase 57's D = 4 on one card: DIST_D gloo ranks (spawned processes)
    sharing cuda:0, through the distributed periodic step (the ring's
    off-diagonal blocks through K4's slab form)."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    try:
        t0 = time.perf_counter()
        mp.start_processes(gloo_card_rank, args=(DIST_D, tmp), nprocs=DIST_D,
                           join=True, start_method="spawn")
        recs = []
        for r in range(DIST_D):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = recs[0]
    rec = dict(seconds=time.perf_counter() - t0, rel_dx=r0["rel_dx"],
               dq=r0["dq"], iters=(r0["iters_single"], r0["iters"]),
               step_launches=[r["step_launches"] for r in recs],
               run_launches=[r["run_launches"] for r in recs],
               steps_per_s=[r["steps_per_s"] for r in recs],
               max_residual=max(r["max_residual"] for r in recs))
    print(f"phase 57, the periodic slice at D = {DIST_D} on one card ("
          f"{DIST_D} gloo ranks): distributed step against the "
          f"single-device step from the same draws {rec['rel_dx']:.3e} of "
          f"max|dX| (tol {STEP_TOL:g}), |dQ| {rec['dq']:.3e}, GMRES "
          f"{rec['iters']}; launches a step by rank {rec['step_launches']}; "
          f"{DIST4_TIMED_STEPS} steps at {rec['steps_per_s']} steps/s by "
          f"rank, launches {rec['run_launches']}")
    ok = (rec["rel_dx"] <= STEP_TOL and all(r["finite"] for r in recs)
          and rec["max_residual"] < 10 * EW_GMRES_TOL
          and all(r["step_launches"].get("ewald_real_slab") for r in recs))
    if not ok:
        raise AssertionError(f"phase 57, D = {DIST_D} on one card: {rec}")
    return rec


def driver_mixture_phase():
    """Phase 58: the polydisperse film's mixture config (poly_film_config)
    with mesh shape [1] (the gather mesh) through python -m
    torch.distributed.run --nproc_per_node 1 (NCCL), DRIVER_MESH_STEPS
    steps, then resumed for as many: the mesh line, the frames rank 0
    wrote without a gap, the checkpoint at the end, every residual below
    10·gmres_tol."""
    from rigid_body_light_tpu_torch.runtime import read_trajectory
    from rigid_body_light_tpu_torch.utils.checkpoint import load_checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mixmesh_")
    try:
        path, conf = poly_film_config(tmp, DRIVER_MESH_STEPS, 5, 5)
        conf["mesh"] = {"shape": [1]}
        with open(path, "w") as f:
            json.dump(conf, f)
        env = dict(os.environ, PYTHONPATH=here)
        base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m",
                "rigid_body_light_tpu_torch.run", path]
        ckpt = os.path.join(conf["output_dir"], "checkpoint.npz")
        lines, times = [], []
        for argv in (base, base + ["--resume", ckpt]):
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=here, env=env,
                                  capture_output=True, text=True,
                                  timeout=300)
            times.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise AssertionError(f"phase 58: {' '.join(argv[2:])} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-3000:]}")
            lines.append([json.loads(ln) for ln in proc.stdout.splitlines()
                          if ln.startswith("{")])
        steps, _, X, Q = read_trajectory(os.path.join(conf["output_dir"],
                                                      "trajectory.rblt"))
        _, _, step, meta = load_checkpoint(ckpt, device="cuda")
        chunks = [ln for run in lines for ln in run if "step" in ln]
        rec = dict(first_line=lines[0][0], steps=steps.tolist(),
                   checkpoint_step=step, launch_s=times,
                   steps_per_s=[ln["steps_per_sec"] for ln in chunks],
                   max_residual=max(ln["max_residual"] for ln in chunks),
                   species_sizes=meta.get("species_sizes"))
        print("phase 58, the mixture on the gather mesh through "
              "torch.distributed.run: " + json.dumps(rec))
        want = list(range(5, 2 * DRIVER_MESH_STEPS + 1, 5))
        checks = {
            "first line": rec["first_line"] == {"mesh": {"blobs": 1},
                                                "mode": "gather"},
            "frames without a gap": rec["steps"] == want,
            "checkpoint at the end": step == 2 * DRIVER_MESH_STEPS,
            "finite": bool(np.isfinite(X).all() and np.isfinite(Q).all()),
            "residuals": rec["max_residual"]
            < 10 * conf["solver"]["gmres_tol"],
        }
        for what, ok in checks.items():
            if not ok:
                raise AssertionError(f"phase 58: {what}: {rec}")
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ensemble_check(torch, dev, counters, mesh):
    """Phase 57's ensemble: make_ensemble_run_bd on a (1, 1) hybrid mesh of
    the process group, 2 walkers of the dense slice (the second shifted),
    each walker bitwise make_distributed_run_bd on ``mesh`` from the same
    draws."""
    from rigid_body_light_tpu_torch import parallel
    from rigid_body_light_tpu_torch.dynamics import stepper
    from rigid_body_light_tpu_torch.state import BodyState

    cfg_d, geom_d, state_d, force_d = slice_setup(torch, dev)
    hmesh = parallel.make_hybrid_mesh(dcn=1, ici=1)
    X = torch.stack([state_d.X, state_d.X + torch.tensor(
        [0.05, -0.05, 0.1], device=dev)])
    Q = torch.stack([state_d.Q, state_d.Q])
    gens = [torch.Generator(device=dev).manual_seed(SEED + w)
            for w in range(2)]
    draws = [[stepper.make_draws(geom_d, state_d, g, cfg_d)
              for _ in range(ENSEMBLE_STEPS)] for g in gens]
    reset_launches(counters)
    fin, traj = parallel.make_ensemble_run_bd(
        geom_d, cfg_d, hmesh, ENSEMBLE_STEPS,
        force_fn=lambda s, i: force_d)(
        BodyState(X=X, Q=Q), draws_fn=lambda w, i: draws[w][i])
    torch.cuda.synchronize()
    cnt = launches(counters)
    diffs = []
    for w in range(2):
        s_w, _ = parallel.make_distributed_run_bd(
            geom_d, cfg_d, mesh, ENSEMBLE_STEPS,
            force_fn=lambda s, i: force_d)(
            BodyState(X=X[w], Q=Q[w]), draws_fn=lambda i, w=w: draws[w][i])
        diffs.append((fin.X[w] - s_w.X).abs().max().item())
    rec = dict(walkers=2, steps=ENSEMBLE_STEPS, max_diff=diffs, launches=cnt,
               traj_shape=list(traj["X"].shape))
    print(f"phase 57, make_ensemble_run_bd on a (1, 1) mesh, 2 walkers x "
          f"{ENSEMBLE_STEPS} steps: each walker against "
          f"make_distributed_run_bd from the same draws {diffs} (bitwise: "
          f"0); trajectory {list(traj['X'].shape)}; launches {cnt}")
    if max(diffs) != 0.0 or not cnt.get("pair_sweep_slab"):
        raise AssertionError(f"phase 57, ensemble: {rec}")
    return rec


def distribution_rest_phases(torch, dev, counters):
    """Phases 55-58: the rest of distribution (ROADMAP item 16): K4's slab
    form and the tile sweep's slices in this process; on an NCCL group of
    this one process each new distributed path against its single-device
    counterpart from the same draws, with steps/s in turns; the periodic
    slice at D = 4 on the one card (gloo ranks); the mixture on the gather
    mesh through the run driver.  Returns the phases' readings."""
    import warnings

    import torch.distributed as dist

    from rigid_body_light_tpu_torch import multi, parallel
    from rigid_body_light_tpu_torch.dynamics import run_bd, stepper
    from rigid_body_light_tpu_torch.utils import profiling

    out = {}
    t = time.perf_counter()
    out["phase55"] = ewald_slab_phase(torch, dev)
    out["phase55"]["seconds"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["phase56"] = tile_slice_phase(torch, dev)
    out["phase56"]["seconds"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    # ---- 57. the new distributed paths on a process group of one
    t57 = time.perf_counter()
    ph = {}
    init_process_group(torch)
    try:
        mesh = parallel.make_mesh(1)

        def single(label, cfg, geom, state, force, tol, timed, bitwise=False,
                   extra=None):
            rec = {}
            p = step_pair(torch, stepper, parallel, geom, cfg, mesh, state,
                          force, SEED + 57)
            print(f"phase 57, {label}: distributed step against "
                  f"single-device {p['rel_dx']:.3e} of max|dX| (tol "
                  f"{tol:g}{', bitwise' if bitwise else ''}), |dQ| "
                  f"{p['dq']:.3e}, GMRES {p['iters']}, residuals "
                  f"{p['residuals']}")
            ok = (p["rel_dx"] <= tol and max(p["residuals"])
                  < 10 * cfg.gmres_tol)
            if bitwise:
                ok = ok and p["rel_dx"] == 0.0 and p["dq"] == 0.0
            if not ok:
                raise AssertionError(f"phase 57, {label}: {p}")
            rec["step"] = p
            run_d = parallel.make_distributed_run_bd(
                geom, cfg, mesh, timed, force_fn=lambda s, i: force)
            warm_d = parallel.make_distributed_run_bd(
                geom, cfg, mesh, DIST_WARM_STEPS, force_fn=lambda s, i: force)

            def gen():
                return torch.Generator(device=dev).manual_seed(SEED)
            runs = {
                "run_bd": (lambda: run_bd(geom, cfg, state, DIST_WARM_STEPS,
                                          generator=gen(),
                                          force_fn=lambda s, i: force),
                           lambda: run_bd(geom, cfg, state, timed,
                                          generator=gen(),
                                          force_fn=lambda s, i: force)[0].X),
                "distributed": (lambda: warm_d(state, generator=gen()),
                                lambda: run_d(state, generator=gen())[0].X)}
            rec["steps_per_s"], rec["launches"] = in_turns(
                torch, counters, label, runs, timed)
            rec["launches_per_step"] = {
                k: v / timed for k, v in rec["launches"]["distributed"].items()}
            rec["split"] = step_split(
                torch, profiling, f"{label} distributed",
                lambda n_: parallel.make_distributed_run_bd(
                    geom, cfg, mesh, n_, force_fn=lambda s, i: force)(
                    state, generator=gen()), 1)
            return rec

        cfg_e, geom_e, state_e = ewald_setup(torch, dev)
        f_e = torch.zeros((state_e.X.shape[0], 6), dtype=torch.float32,
                          device=dev)
        ph["periodic classic"] = single("periodic slice, classic split",
                                        cfg_e, geom_e, state_e, f_e,
                                        STEP_TOL, DIST_TIMED_STEPS,
                                        bitwise=True)
        if not ph["periodic classic"]["launches_per_step"].get(
                "ewald_real_sweep"):
            raise AssertionError("phase 57: the distributed periodic step "
                                 "launched no ewald_real_sweep")
        r_e = state_e.X
        from rigid_body_light_tpu_torch.ops import ewald_cells
        from rigid_body_light_tpu_torch.ops import kinematics as kin
        n_e = geom_e.n_blobs * r_e.shape[0]
        cfg_rc = cfg_e.replace(ewald_rc=BAL_RC, ewald_nbr_tiles=-(-n_e //
                                                              ewald_cells.TILE))
        ph["periodic balanced"] = single(
            f"periodic slice, ewald_rc {BAL_RC}, dense wave part", cfg_rc,
            geom_e, state_e, f_e, STEP_TOL, DIST4_TIMED_STEPS, bitwise=True)
        if not ph["periodic balanced"]["launches_per_step"].get(
                "ewald_real_tiles"):
            raise AssertionError("phase 57: the distributed balanced step "
                                 "launched no ewald_real_tiles")

        cfg_s, geom_s, state_s, force_fn_s = settled_setup(torch, dev)
        f_s = force_fn_s(state_s, 0)
        ph["settled RAS"] = single("settled slice, RAS", cfg_s, geom_s,
                                   state_s, f_s, STEP_TOL, DIST4_TIMED_STEPS)
        bf = step_pair(torch, stepper, parallel, geom_s,
                       cfg_s.replace(pc_mode="block_free"), mesh, state_s,
                       f_s, SEED + 57)
        ph["settled RAS"]["block_free_iters"] = bf["iters"]
        print(f"phase 57, settled slice: RAS GMRES "
              f"{ph['settled RAS']['step']['iters']} against block_free "
              f"{bf['iters']} (single-device, distributed)")
        if not ph["settled RAS"]["step"]["iters"][1] < bf["iters"][1]:
            raise AssertionError("phase 57: distributed RAS took no fewer "
                                 "iterations than block_free")
        del cfg_s, geom_s, state_s

        def mixture(label, cfg, mgeom, states, forces, tol, timed,
                    bitwise=False):
            p = step_pair_multi(torch, multi, parallel, mgeom, cfg, mesh,
                                states, forces, SEED + 57)
            print(f"phase 57, {label}: distributed mixture step against "
                  f"single-device {p['rel_dx']:.3e} of max|dX| (tol "
                  f"{tol:g}{', bitwise' if bitwise else ''}), |dQ| "
                  f"{p['dq']:.3e}, GMRES {p['iters']}, residuals "
                  f"{p['residuals']}")
            ok = (p["rel_dx"] <= tol and max(p["residuals"])
                  < 10 * cfg.gmres_tol)
            if bitwise:
                ok = ok and p["rel_dx"] == 0.0 and p["dq"] == 0.0
            if not ok:
                raise AssertionError(f"phase 57, {label}: {p}")
            rec = {"step": p}
            run_d = parallel.make_distributed_run_bd_multi(
                mgeom, cfg, mesh, timed, force_fn=lambda ss, i: forces)
            warm_d = parallel.make_distributed_run_bd_multi(
                mgeom, cfg, mesh, DIST_WARM_STEPS,
                force_fn=lambda ss, i: forces)

            def gen():
                return torch.Generator(device=dev).manual_seed(SEED)
            runs = {
                "run_bd_multi": (
                    lambda: multi.run_bd_multi(
                        mgeom, cfg, states, DIST_WARM_STEPS, generator=gen(),
                        force_fn=lambda ss, i: forces),
                    lambda: multi.run_bd_multi(
                        mgeom, cfg, states, timed, generator=gen(),
                        force_fn=lambda ss, i: forces)[0][0].X),
                "distributed": (lambda: warm_d(states, generator=gen()),
                                lambda: run_d(states,
                                              generator=gen())[0][0].X)}
            rec["steps_per_s"], rec["launches"] = in_turns(
                torch, counters, label, runs, timed)
            rec["launches_per_step"] = {
                k: v / timed for k, v in rec["launches"]["distributed"].items()}
            rec["split"] = step_split(
                torch, profiling, f"{label} distributed",
                lambda n_: parallel.make_distributed_run_bd_multi(
                    mgeom, cfg, mesh, n_, force_fn=lambda ss, i: forces)(
                    states, generator=gen()), 1)
            return rec

        cfg_m, mgeom_m, states_m, forces_m = mixture_setup(torch, dev)
        ph["mixture POLY ring"] = mixture(
            "mixture, the POLY ring", cfg_m, mgeom_m, states_m, forces_m,
            STEP_TOL, DIST_TIMED_STEPS)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            cfg_fm, mgeom_fm, states_fm, forces_fm = farfield_mixture_setup(
                torch, dev, FF_BODIES)
        ph["far-field mixture"] = mixture(
            "far-field mixture", cfg_fm, mgeom_fm, states_fm, forces_fm,
            STEP_TOL, FF_TIMED_STEPS, bitwise=True)
        del cfg_fm, mgeom_fm, states_fm, forces_fm
        torch.cuda.empty_cache()
        cfg_fb, geom_fb, state_fb, force_fb = farfield_setup(
            torch, dev, FF_BODIES, side=FB_SIDE, box=FB_BOX, grid=FB_GRID)
        ph["far-field film"] = single(
            "far-field film", cfg_fb, geom_fb, state_fb, force_fb, STEP_TOL,
            DIST4_TIMED_STEPS, bitwise=True)
        del cfg_fb, geom_fb, state_fb, force_fb
        torch.cuda.empty_cache()

        ph["ensemble"] = ensemble_check(torch, dev, counters, mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    ph["periodic D = 4 on one card"] = gloo_card_phase(torch)
    ph["seconds"] = time.perf_counter() - t57
    out["phase57"] = ph
    t = time.perf_counter()
    out["phase58"] = driver_mixture_phase()
    out["phase58"]["seconds"] = time.perf_counter() - t
    return out


def tile_steps(torch, ewald_cells, r_pad, ids_pad, pairs, params):
    """Over the listed tile pairs (a, b ≥ a) of K4 tiles' work list, as the
    kernel selects pairs (both ids >= 0, they differ, j > i on a diagonal
    pair, r <= rc): the kept unordered pairs, the kernel's executed warp
    steps (8 × 8 sub-blocks with a kept pair; the others are skipped by its
    vote) and those K1's and K3's column rotation would execute (lane l at
    columns (l + s) mod 32 and (l + s + 16) mod 32, 16 steps a pair): this
    run's work and each schedule's share of kept pairs in its steps."""
    T = 32
    t = r_pad.shape[0] // T
    dev = r_pad.device
    rt = r_pad.reshape(t, T, 3)
    it = ids_pad.reshape(t, T)
    lane = torch.arange(T, device=dev)
    upper = lane[:, None] < lane[None, :]
    subs = torch.arange(T // 8, device=dev)
    lower_sub = subs[:, None] > subs[None, :]
    kept = sub_steps = rot_steps = 0
    for c in range(0, pairs.shape[0], KEPT_CHUNK):
        P = pairs[c:c + KEPT_CHUNK].long()
        I, J = P[:, 0], P[:, 1]
        diag = (I == J)[:, None, None]
        d = ewald_cells._min_image(rt[I][:, :, None], rt[J][:, None],
                                   params.box)
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[
            ..., 2]
        ci, cj = it[I][:, :, None], it[J][:, None, :]
        ok = (cj >= 0) & (ci >= 0) & (ci != cj) & (~diag | upper)
        rr = torch.sqrt(torch.where(ok, torch.clamp(r2, min=1e-24),
                                    torch.ones_like(r2)))
        K = ok & (rr <= params.rc)
        kept += int(K.sum())
        blocks = K.reshape(-1, T // 8, 8, T // 8, 8).any(4).any(2)
        sub_steps += int((blocks & ~(diag & lower_sub)).sum())
        for step in range(T // 2):
            m = K[:, lane, (lane + step) % T] | K[:, lane,
                                                  (lane + step + 16) % T]
            rot_steps += int(m.any(1).sum())
    return dict(kept_unordered_pairs=kept, executed_steps=sub_steps,
                kept_share=kept / (64 * sub_steps) if sub_steps else 0.0,
                rotation_steps=rot_steps,
                rotation_kept_share=kept / (64 * rot_steps) if rot_steps
                else 0.0)


def tiles_bound(kept, deg, k, n_pad, n_lists, poly=False):
    """K4 tiles' bound: K4's 36 + 6·D + 36·k flop an unordered pair over
    this run's kept pairs, against its operands read once (positions, ids,
    forces, species, the work list's n_lists ints) and its output written
    once."""
    flops = kept / 2 * (36 + 6 * deg + 36 * k)
    n_bytes = n_pad * (12 + 4 + 12 * k + (4 if poly else 0) + 12 * k) \
        + 4 * n_lists
    return bound_ms(flops, n_bytes)


def tile_kernel_phase(torch, dev, counters):
    """Phase 59: K4 tiles (ewald_cuda.tile_pair_sum) at the balanced
    split's shapes: against its plain twin (ewald_cells._cell_sweep) and
    the float64 all-pairs sweep with the cut, repeats, slices, the NaN
    poison of a narrow list, times beside bounds.  Returns its readings."""
    from rigid_body_light_tpu_torch import multi
    from rigid_body_light_tpu_torch.ops import (ewald, ewald_cells,
                                                ewald_cuda, saddle)
    from rigid_body_light_tpu_torch.ops import kinematics as kin

    out = {}
    rng = np.random.default_rng(SEED + 59)

    def f64_ref(F, r, params, rows, pt=None):
        """The float64 all-pairs sweep with the cut, on ``rows`` (None:
        all) of positions r: the same Chebyshev fits in float64."""
        n = r.shape[0]
        r64, F64 = r.double(), F.double()
        ids = torch.arange(n, device=dev)
        rr_ = r64 if rows is None else r64[rows]
        ri = ids if rows is None else rows
        if pt is None:
            return ewald.real_space_block(rr_, ri, r64, ids, F64, params,
                                          cheb=True)
        sidx = ewald.poly_device_tables(pt, torch.float64, dev)[0]
        si = sidx if rows is None else sidx[rows]
        return ewald._sweep(
            rr_, ri, r64, ids, F64, params, 512,
            lambda rr, sl: ewald.pair_scalars(rr, params, True,
                                              si=si[sl, None],
                                              sj=sidx[None, :], pt=pt))

    def case(label, r, params, rows=None, radii=None, pt=None):
        n = r.shape[0]
        F = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev).float()
        rf = ewald_cells._fold(r, params)
        w = nbr_tiles(ewald_cells, r)
        order, r_pad, ids_pad, F_pad, pp, nbr, overflow = \
            ewald_cells.sorted_tiles(rf, F, params, w, radii=radii,
                                     poly_tables=pt)
        deg = ewald_cuda._tile_table_size(params, pt)[1]
        t = nbr.shape[0]
        lst = ewald_cuda.tile_list(nbr, 0, t)
        n_pairs = int(lst.n_pairs)
        steps = tile_steps(torch, ewald_cells, r_pad, ids_pad,
                           lst.pairs[:n_pairs], params)
        kept = 2 * steps["kept_unordered_pairs"]
        rec = dict(n=n, tiles=t, degree=deg,
                   list_width=int((nbr >= 0).sum(dim=1).max()),
                   live_entries=int((nbr >= 0).sum()), tile_pairs=n_pairs,
                   partials=lst.cap, kept_ordered_pairs=kept,
                   overflow=bool(overflow), **steps)
        rec["list_ms"] = cuda_ms(torch, lambda: ewald_cuda.tile_list(
            nbr, 0, t), 5)
        ids32 = ids_pad.to(torch.int32).contiguous()
        sp32 = None if pp is None else pp[1].to(torch.int32).contiguous()
        real = ids_pad >= 0
        for k in (1, 2):
            Fk = F_pad[:k].contiguous()
            reset_launches(counters)
            U = ewald_cuda.tile_pair_sum(r_pad, ids_pad, Fk, nbr, params,
                                         poly=pp)
            U2 = ewald_cuda.tile_pair_sum(r_pad, ids_pad, Fk, nbr, params,
                                          poly=pp)
            torch.cuda.synchronize()
            rec[f"launches_{k}"] = launches(counters)
            twin = ewald_cells._cell_sweep(r_pad, ids_pad, Fk, nbr, params,
                                           poly=pp)
            rec[f"twin_rel_{k}"] = op_rel(U[:, real], twin[:, real])
            rec[f"repeat_bitwise_{k}"] = bool(torch.equal(U, U2))
            rec[f"finite_{k}"] = bool(torch.isfinite(U).all())
            rec[f"scratch_bytes_{k}"] = lst.cap * k * 32 * 3 * 4
            U_o = torch.empty((k, n, 3), dtype=U.dtype, device=dev)
            U_o[:, order] = U[:, :n]
            sel = slice(None) if rows is None else rows
            ref = f64_ref(F[:k], rf, params, rows, pt)
            rec[f"f64_rel_{k}"] = op_rel(U_o[:, sel], ref)
            rec[f"f64_abs_{k}"] = (U_o[:, sel].double() - ref).abs().max(
                ).item()
            rec[f"twin_f64_rel_{k}"] = op_rel(
                torch.empty_like(U_o).index_copy_(1, order, twin[:, :n])[
                    :, sel], ref)
            rec[f"f64_unfolded_rel_{k}"] = op_rel(
                U_o[:, sel], f64_ref(F[:k], r, params, rows, pt))
            del ref
            rec[f"ms_{k}"] = cuda_ms(
                torch, lambda: ewald_cuda.tile_sweep_launch(
                    r_pad, ids32, Fk, sp32, lst, params, pt, 0, t), 10)
            rec[f"wrapper_ms_{k}"] = cuda_ms(
                torch, lambda: ewald_cuda.tile_pair_sum(
                    r_pad, ids_pad, Fk, nbr, params, poly=pp), 5)
            rec[f"plain_ms_{k}"] = cuda_ms(
                torch, lambda: ewald_cells._cell_sweep(
                    r_pad, ids_pad, Fk, nbr, params, poly=pp), 2)
            b = tiles_bound(kept, deg, k, r_pad.shape[0],
                            4 * n_pairs + t + 1, poly=pt is not None)
            rec[f"bound_ms_{k}"], rec["bound_by"] = b
            rec[f"bound_ratio_{k}"] = rec[f"ms_{k}"] / b[0]
            del U, U2, twin, U_o
        print(f"phase 59, K4 tiles at {label}: " + json.dumps(rec))
        return rec, (rf, F, pp, pt, radii)

    def check(label, rec):
        for k in (1, 2):
            ok = (rec[f"twin_rel_{k}"] <= KERNEL_TOL
                  and rec[f"f64_rel_{k}"] <= TILES_F64_TOL
                  and rec[f"repeat_bitwise_{k}"] and rec[f"finite_{k}"]
                  and rec[f"launches_{k}"] == {"ewald_real_tiles": 2}
                  and not rec["overflow"])
            if not ok:
                raise AssertionError(f"phase 59, {label}, {k} RHS: {rec}")

    def slices(label, rf, F, params, pp_args, k):
        """The row-tile slices for D = 1, 2, 4 ranks: their union bitwise
        the whole launch on the same padded tiles."""
        res = {}
        for d in (1, 2, 4):
            _, r_pad, ids_pad, F_pad, pp, nbr, _ = ewald_cells.sorted_tiles(
                rf, F[:k], params, -(-rf.shape[0] // 32), d, **pp_args)
            whole = ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr,
                                             params, poly=pp)
            nt = nbr.shape[0] // d
            parts = [ewald_cuda.tile_pair_sum(r_pad, ids_pad, F_pad, nbr,
                                              params, poly=pp, t0=i * nt,
                                              nt=nt) for i in range(d)]
            res[d] = bool(torch.equal(torch.cat(parts, dim=1), whole))
        print(f"phase 59, {label} slices at {k} RHS: union bitwise the "
              f"whole launch at D = 1, 2, 4: {res}")
        if not all(res.values()):
            raise AssertionError(f"phase 59, {label}: slices {res}")
        return res

    # phase 42's positions: the periodic slice in L = 14
    torch.cuda.empty_cache()
    cfg_e, geom_e, state_e = ewald_setup(torch, dev)
    r42 = kin.blob_positions(geom_e, state_e.X, state_e.Q).reshape(-1, 3)
    par42 = ewald.make_params(EW_BOX, cfg_e.a, cfg_e.eta, tol=EW_TOL,
                              rc=BAL_RC)
    out["phase42"], (rf42, F42, _, _, _) = case("phase 42's positions",
                                                r42, par42)
    check("phase 42's positions", out["phase42"])
    out["phase42"]["slices_2rhs"] = slices("phase 42's positions", rf42,
                                           F42, par42, {}, 2)
    # a list one slot narrower than the widest poisons the apply
    width = ewald_cells.neighbor_width(r42, par42)
    U_ok = ewald_cells.real_space_apply_cells(F42, r42, par42, width)
    U_bad = ewald_cells.real_space_apply_cells(F42, r42, par42, width - 1)
    out["phase42"]["narrow_list"] = dict(
        width=width, finite_at_width=bool(torch.isfinite(U_ok).all()),
        nan_one_narrower=bool(torch.isnan(U_bad).all()))
    print(f"phase 59, a list one narrower than the widest ({width}): "
          + json.dumps(out["phase42"]["narrow_list"]))
    if not (out["phase42"]["narrow_list"]["finite_at_width"]
            and out["phase42"]["narrow_list"]["nan_one_narrower"]):
        raise AssertionError("phase 59: the narrow list does not poison")
    del U_ok, U_bad

    # phase 43's points: 102,400 uniform in L = 30, rc 3.5 and 4.5
    rng0 = np.random.default_rng(0)
    L = PME_BENCH_L
    r43 = torch.from_numpy(rng0.uniform(0, L, (PME_BENCH_N, 3))).to(
        dev).float()
    rows43 = torch.from_numpy(np.sort(rng.choice(
        PME_BENCH_N, SCALE_ROWS, replace=False))).to(dev)
    for rc in PME_BENCH_RCS:
        torch.cuda.empty_cache()
        par = ewald.make_params((L, L, L), PME_BENCH_A, 1.0, tol=EW_TOL,
                                rc=rc)
        key = f"phase43_rc{rc}"
        out[key], _ = case(f"phase 43's points, rc {rc}", r43, par,
                           rows=rows43)
        check(f"phase 43's points, rc {rc}", out[key])
    del r43

    # phase 44's positions: 115,560 blobs in L = 30, C timed
    torch.cuda.empty_cache()
    cfg_s, geom_s, state_s = balanced_split_setup(torch, dev)
    par44 = saddle._ewald_params(*saddle._ewald_params_key(cfg_s))
    r44 = kin.blob_positions(geom_s, state_s.X, state_s.Q).reshape(-1, 3)
    rows44 = torch.from_numpy(np.sort(rng.choice(
        r44.shape[0], SCALE_ROWS, replace=False))).to(dev)
    out["phase44"], _ = case("phase 44's positions", r44, par44, rows=rows44)
    check("phase 44's positions", out["phase44"])
    del r44

    # phase 45's mixture: the POLY form
    torch.cuda.empty_cache()
    cfg_m, mgeom, states, _ = mixture_setup(torch, dev, poly=True)
    cfg_45 = cfg_m.replace(wall=False, box=EW_BOX, ewald_tol=EW_TOL,
                           ewald_rc=BAL_RC, ewald_grid_p=BAL_P)
    opses = multi.geometry_ops_multi(mgeom, states)
    radii = multi.blob_radii_multi(mgeom, opses, cfg_45).float()
    r45 = multi.concat_positions(opses).float()
    par45 = saddle._ewald_params(*saddle._ewald_params_key(cfg_45))
    pt45 = ewald.make_poly_tables(par45, radii)
    out["poly"], (rf45, F45, _, _, _) = case(
        "phase 45's mixture (POLY)", r45, par45, radii=radii, pt=pt45)
    out["poly"]["fits"] = int(pt45.bounds.shape[0])
    check("phase 45's mixture (POLY)", out["poly"])
    out["poly"]["slices_1rhs"] = slices(
        "phase 45's mixture (POLY)", rf45, F45, par45,
        dict(radii=radii, poly_tables=pt45), 1)
    return out


def tiles_entry(bal, d):
    """The kernels line's entry of K4 tiles: launches on phase 44's run_bd,
    its error and times at phase 44's positions (phase 59), the other
    shapes' beside."""
    p44 = d["phase44"]
    return {
        "name": "ewald_real_tiles", "route": "cuda", "source": K4_SOURCE,
        "replaces": "rigid_body_light_tpu/ops/ewald_cells.py:122",
        "replaces_kind": "the JAX package's plain-XLA _cell_sweep; no "
                         "Pallas kernel",
        "launches": bal["phase44"]["launches"].get("ewald_real_tiles", 0),
        "max_abs_err": max(p44["f64_abs_1"], p44["f64_abs_2"]),
        "max_rel_err_f64": max(
            v[f"f64_rel_{k}"] for v in d.values() if isinstance(v, dict)
            and "f64_rel_1" in v for k in (1, 2)),
        "ms": p44["ms_1"], "plain_ms": p44["plain_ms_1"],
        "bound_ms": p44["bound_ms_1"], "bound_by": p44["bound_by"],
        "library_ms": None, "ms_2rhs": p44["ms_2"],
        "plain_ms_2rhs": p44["plain_ms_2"], "bound_ms_2rhs": p44["bound_ms_2"],
        "redesigned_in": 18,
        "list_ms": p44["list_ms"], "wrapper_ms": p44["wrapper_ms_1"],
        "wrapper_ms_2rhs": p44["wrapper_ms_2"],
        "scratch_bytes": p44["scratch_bytes_1"],
        "scratch_bytes_2rhs": p44["scratch_bytes_2"],
        "kept_share": p44["kept_share"],
        "rotation_kept_share": p44["rotation_kept_share"],
        **{f"ms_{key}_{k}rhs": v[f"ms_{k}"] for key, v in d.items()
           if isinstance(v, dict) and "ms_1" in v for k in (1, 2)},
        **{f"bound_ms_{key}_{k}rhs": v[f"bound_ms_{k}"]
           for key, v in d.items() if isinstance(v, dict) and "ms_1" in v
           for k in (1, 2)},
        "launches_poly_mixture_run": bal["phase45"]["launches"].get(
            "ewald_real_tiles", 0)}


def ewald_slab_entry(d):
    """The kernels line's entry of K4's slab form (phases 55 and 57):
    launches on the distributed periodic step at D = 4 on the one card
    (rank 0's, phase 57), its error at the periodic slice (phase 55, the
    rings over 4 and 2 ranks), its ms at the main path's shape there (a
    rank's n/4 × n/4 ring slab at 1 RHS) and the other shapes' (the D = 2
    ring's n/2 × n/2, the gather's, one rank's), each beside its bound."""
    t = d["phase55"]["times"]
    main_ = t[("ring", 1)]
    four = d["phase57"]["periodic D = 4 on one card"]
    return {
        "name": "ewald_real_slab", "route": "cuda", "source": K4_SOURCE,
        "replaces": "rigid_body_light_tpu/ops/ewald_pallas.py:81",
        "entry_replaces": "rigid_body_light_tpu/ops/ewald.py:788",
        "launches": four["run_launches"][0].get("ewald_real_slab", 0),
        "max_abs_err": max(v["err"] for key in ("ring", "ring_d2")
                           for v in d["phase55"][key].values()),
        "ms": main_["ms"], "plain_ms": main_["plain_ms"],
        "bound_ms": main_["bound_ms"], "bound_by": main_["bound_by"],
        "library_ms": None,
        **{f"ms_{key}_{k}rhs": v["ms"] for (key, k), v in t.items()},
        **{f"bound_ms_{key}_{k}rhs": v["bound_ms"] for (key, k), v in
           t.items()},
        "launches_per_step_d4": four["step_launches"][0].get(
            "ewald_real_slab", 0),
        "launches_per_step_world1": d["phase57"]["periodic classic"][
            "launches_per_step"].get("ewald_real_slab", 0)}


def jsonable(x):
    """x with every mapping key a string (tuple keys joined by spaces)."""
    if isinstance(x, dict):
        return {(" ".join(map(str, k)) if isinstance(k, tuple) else str(k)):
                jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    return x


def distributed_entries(d):
    """The kernels line's entry of K2's slab entries (phases 50 and 52):
    launches on the distributed dense run (phase 52), the slab's error at
    the dense slice (phase 50, the worst decomposition at 2 RHS), its ms at
    the main path's one-rank n × n slab and the decompositions' slabs."""
    t = d["phase50"]["times"]
    main_ = t[("one_rank", 1)]
    errs = d["phase50"]["dense"]
    dense = d["phase52"]["dense"]
    return {
        "name": "pair_sweep_slab", "route": "cuda", "source": SOURCE,
        "replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:175",
        "entry_replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:648",
        "launches": dense["distributed launches"].get("pair_sweep_slab", 0),
        "max_abs_err": max(v["err"] for v in errs.values()),
        "ms": main_["ms"], "plain_ms": main_["plain_ms"],
        "bound_ms": main_["bound_ms"], "bound_by": main_["bound_by"],
        "library_ms": None,
        **{f"ms_{key}_{k}rhs": v["ms"] for (key, k), v in t.items()},
        **{f"bound_ms_{key}_{k}rhs": v["bound_ms"] for (key, k), v in
           t.items()},
        "launches_per_step": dense["distributed launches per step"].get(
            "pair_sweep_slab", 0),
        "launches_gather_mode": d["phase52"]["gather mode"]["launches"].get(
            "pair_sweep_slab", 0)}


def slice_entry(d):
    """The kernels line's entry of K3's row-tile slice (phases 51 and 52):
    launches on the distributed far-field run (phase 52), its error at the
    far-field slice (phase 51), its ms at the main path's one-rank slice
    (D = 1) and at D = 4's slowest slice."""
    ff = d["phase51"]["far-field slice"]
    one = ff[1][1]["slices"][0]
    four = max(ff[4][1]["slices"], key=lambda v: v["ms"])
    far = d["phase52"]["far field p = 4"]
    return {
        "name": "near_sweep_slice", "route": "cuda", "source": K3_SOURCE,
        "replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:908",
        "entry_replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:1094",
        "launches": far["distributed launches"].get("near_sweep_slice", 0),
        "max_abs_err": max(ff[D][k]["err"] for D in ff for k in (1, 2)),
        "ms": one["ms"], "plain_ms": one["plain_ms"],
        "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
        "library_ms": None,
        "ms_2rhs": ff[1][2]["slices"][0]["ms"],
        "bound_ms_2rhs": ff[1][2]["slices"][0]["bound_ms"],
        "ms_d4_slowest_slice": four["ms"],
        "bound_ms_d4_slowest_slice": four["bound_ms"],
        "boundary_pairs_d4": ff[4]["boundary_pairs"],
        "launches_per_step": far["distributed launches per step"].get(
            "near_sweep_slice", 0),
        "launches_per_step_band6": d["phase52"]["far field band 6"][
            "distributed launches per step"].get("near_sweep_slice", 0)}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's main path runs on the "
              "GPU only", file=sys.stderr)
        return 1
    try:
        from rigid_body_light_tpu_torch.dynamics import (make_draws, run_bd,
                                                         stochastic_step)
        from rigid_body_light_tpu_torch.ops import (cuda_build, ewald,
                                                    ewald_cuda, farfield,
                                                    farfield_cuda, rpy,
                                                    rpy_cuda, saddle)
        from rigid_body_light_tpu_torch.ops import solvers, tiles
        from rigid_body_light_tpu_torch.utils import profiling, roofline
        from rigid_body_light_tpu_torch import multi
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 0. the card
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {kind}, count {torch.cuda.device_count()}")

    # ---- 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    built = cuda_build.build()
    BUILD_LOGS.update({name: log for name, (_, log) in built.items()})
    rpy_cuda.build()
    farfield_cuda.build()
    ewald_cuda.build()
    roofline.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, (path, log) in built.items():
        print(f"  {name} -> {path}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    cfg, geom, state, force = slice_setup(torch, dev)
    from rigid_body_light_tpu_torch.ops import kinematics as kin
    r_slice = kin.blob_positions(geom, state.X, state.Q).reshape(-1, 3)
    n = r_slice.shape[0]
    a, eta, h = cfg.a, cfg.eta, cfg.wall_h_floor
    rng = np.random.default_rng(SEED)
    F2 = torch.from_numpy(rng.standard_normal((2, n, 3))).to(dev)
    ragged = torch.from_numpy(
        rng.uniform([-12 * a, -12 * a, 0.3 * a], [12 * a, 12 * a, 8 * a],
                    (1000, 3))).to(dev)
    Fr = torch.from_numpy(rng.standard_normal((2, 1000, 3))).to(dev)

    # ---- 2. K1 vs plain
    k1_err = check_kernel(
        torch, "K1 pair_sweep_sym",
        lambda F, r, a_, e_, w: rpy_cuda.mobility_apply(F[0], r, a_, e_, w),
        lambda F, r, a_, e_, w: rpy.mobility_apply(F[0], r, a_, e_, w),
        [("slice", r_slice, F2), ("ragged", ragged, Fr)],
        a, eta)
    def plain_pairs(F, r, a_, e_, w):
        ids_ = torch.arange(r.shape[0], device=dev)
        return rpy.pair_sum(r / a_, ids_, r / a_, ids_, F, wall=w, h_floor=h)

    k1_err2 = check_kernel(
        torch, "K1 pair_sweep_sym 2 RHS (pair terms)",
        lambda F, r, a_, e_, w: rpy_cuda.pair_sweep_sym(
            (r / a_).contiguous(), F.contiguous(), w, h),
        plain_pairs, [("slice", r_slice, F2), ("ragged", ragged, Fr)],
        a, eta)
    r32 = (r_slice / a).contiguous()
    F32 = F2.float().contiguous()
    ids = torch.arange(n, device=dev)
    for k in (1, 2):
        U1 = rpy_cuda.pair_sweep_sym(r32, F32[:k].contiguous(), True, h)
        U2 = rpy_cuda.pair_sweep_sym(r32, F32[:k].contiguous(), True, h)
        if not torch.equal(U1, U2):
            raise AssertionError(f"two K1 launches differ bitwise, k={k}")
    print(f"K1 launches repeat bitwise at 1 and 2 RHS; max|dU| at 2 RHS "
          f"{k1_err2:.3e}")
    k1_ms = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_sym(
        r32, F32[0], True, h), 20)
    k1_plain_ms = cuda_ms(torch, lambda: rpy.pair_sum(
        r32, ids, r32, ids, F32[0], wall=True, h_floor=h), 3)
    k1_gflops = n * n * (60 + 2 * 30) / 2 / (k1_ms * 1e-3) / 1e9
    print(f"K1 time at n={n}, wall, 1 RHS: kernel {k1_ms:.4f} ms "
          f"({k1_gflops:.1f} GFLOP/s at 60 flop/ordered pair), plain "
          f"float32 {k1_plain_ms:.4f} ms")

    # ---- 3. K2 vs plain
    k2_err = check_kernel(
        torch, "K2 pair_sweep_ordered",
        lambda F, r, a_, e_, w: rpy_cuda.mobility_apply_multi(F, r, a_, e_, w),
        lambda F, r, a_, e_, w: rpy.mobility_apply_multi(F, r, a_, e_, w),
        [("slice", r_slice, F2), ("ragged", ragged, Fr)],
        a, eta)
    check_kernel(
        torch, "K2 pair_sweep_ordered 1 RHS (pair terms)",
        lambda F, r, a_, e_, w: rpy_cuda.pair_sweep_ordered(
            (r / a_).contiguous(), 0, (r / a_).contiguous(),
            F[:1].contiguous(), 0, w, h),
        lambda F, *rest: plain_pairs(F[:1], *rest),
        [("slice", r_slice, F2), ("ragged", ragged, Fr)],
        a, eta)
    U1 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, True, h)
    U2 = rpy_cuda.pair_sweep_ordered(r32, 0, r32, F32, 0, True, h)
    if not torch.equal(U1, U2):
        raise AssertionError("two K2 launches differ bitwise")
    print("K2 launches repeat bitwise")
    k2_ms = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_ordered(
        r32, 0, r32, F32, 0, True, h), 20)
    k2_plain_ms = cuda_ms(torch, lambda: rpy.pair_sum(
        r32, ids, r32, ids, F32, wall=True, h_floor=h), 3)
    k1_ms2 = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_sym(
        r32, F32, True, h), 20)
    k2_gflops = n * n * (60 + 2 * 2 * 30) / 2 / (k2_ms * 1e-3) / 1e9
    print(f"K2 time at n={n}, wall, 2 RHS: kernel {k2_ms:.4f} ms "
          f"({k2_gflops:.1f} GFLOP/s at 90 flop/ordered pair), plain "
          f"float32 {k2_plain_ms:.4f} ms; K1 at 2 RHS {k1_ms2:.4f} ms, "
          f"{k2_ms / k1_ms2:.3f}x faster than K2 (the dispatch keeps K2 "
          f"below 65,025 blobs, as the JAX package does)")

    # ---- 4. the slice through the kernels
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x0 = state.X.clone()
    rpy_cuda.reset_launch_counts()
    farfield_cuda.reset_launch_counts()
    s, tr_w = run_bd(geom, cfg, state, WARM_STEPS, generator=gen,
                     force_fn=lambda s_, i: force)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, tr = run_bd(geom, cfg, s, TIMED_STEPS, generator=gen,
                   force_fn=lambda s_, i: force)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = rpy_cuda.launch_counts()
    res = torch.cat([tr_w["residual"], tr["residual"]])
    iters = torch.cat([tr_w["iters"], tr["iters"]]).double()
    print(f"slice: {N_BODIES} x {SHELL} = {n} blobs, {TIMED_STEPS} steps in "
          f"{wall_s:.3f} s = {TIMED_STEPS / wall_s:.4f} steps/s; max residual "
          f"{res.max().item():.3e}; mean GMRES iters {iters.mean().item():.2f};"
          f" max noise_err {tr['noise_err'].max().item():.3e}; launches "
          f"{counts}")
    qn = torch.linalg.norm(s.Q, dim=1)
    checks = {
        "max residual < 10 gmres_tol": res.max().item() < 10 * cfg.gmres_tol,
        "state finite": bool(torch.isfinite(s.X).all()
                             and torch.isfinite(s.Q).all()),
        "|q| within 1e-5 of 1": (qn - 1).abs().max().item() <= 1e-5,
        "bodies moved": (s.X - x0).abs().max().item() > 0,
        "K1 launched": counts["pair_sweep_sym"] > 0,
        "K2 launched": counts["pair_sweep_ordered"] > 0,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"slice check failed: {what}")

    # ---- 5. kernel step vs plain step, identical draws
    draws = make_draws(geom, s, gen)
    s_k, aux_k = stochastic_step(geom, cfg, s, force, draws=draws)
    s_p, aux_p = stochastic_step(geom, cfg.replace(use_pallas=False), s,
                                 force, draws=draws)
    torch.cuda.synchronize()
    dX_k, dX_p = s_k.X - s.X, s_p.X - s.X
    rel = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    print(f"step kernel vs plain: max|dX_k - dX_p|/max|dX_p| = {rel:.3e} "
          f"(tol {STEP_TOL:g}); iters {aux_k.iters} vs {aux_p.iters}; "
          f"residual {aux_k.residual.item():.3e} vs "
          f"{aux_p.residual.item():.3e}")
    if not (rel <= STEP_TOL and torch.isfinite(s_k.X).all()):
        raise AssertionError(f"kernel step disagrees with the plain step: "
                             f"{rel}")

    # ---- 6. K3 vs plain, then its time at the at-scale slice's shape
    cfg_c, geom_c, state_c, force_c = farfield_setup(torch, dev,
                                                     FF_CHECK_BODIES)
    a_ff = cfg_c.a
    geom_c64 = geom_c._replace(**{f: getattr(geom_c, f).double()
                                  for f in geom_c._fields})
    r_c64 = kin.blob_positions(geom_c64, state_c.X.double(),
                               state_c.Q.double()).reshape(-1, 3)
    check_near(torch, farfield, farfield_cuda, "check", r_c64, a_ff, FF_GRID)
    clump = np.concatenate([
        rng.uniform([0, 0, 0.3], [30, 30, 8], (2000, 3)),
        rng.uniform([60, 60, 0.3], [80, 80, 8], (1500, 3))]) * a_ff
    check_near(torch, farfield, farfield_cuda, "ragged",
               torch.from_numpy(clump).to(dev), a_ff, (6, 6, 3))
    # three clumps in cells far apart, 128, 128 and 70 blobs in cell-snake
    # order, so every tile lists only itself (K3 sweeps each diagonal pair
    # alone) and the last tile is partial, its pad rows on its last blob
    # (its own generator, so the later phases draw what they drew before)
    rng_l = np.random.default_rng(SEED + 3)
    lone = np.concatenate([
        rng_l.uniform([0, 0, 0.3], [3, 3, 3], (128, 3)),
        rng_l.uniform([0, 40, 0.3], [3, 43, 3], (128, 3)),
        rng_l.uniform([40, 0, 0.3], [43, 3, 3], (70, 3))]) * a_ff
    ctx_l = farfield.prepare(torch.from_numpy(lone).to(dev), a=a_ff,
                             wall=True, grid=(4, 4, 1), p=FF_P)
    if not (ctx_l.nbr.shape[0] == 3 and int(ctx_l.n_pairs.item()) == 3):
        raise AssertionError("the lone-clump cloud does not give three tiles "
                             "with only their diagonal pair")
    check_near(torch, farfield, farfield_cuda, "diagonal-only",
               torch.from_numpy(lone).to(dev), a_ff, (4, 4, 1))

    cfg_f, geom_f, state_f, force_f = farfield_setup(torch, dev, FF_BODIES)
    r_f = kin.blob_positions(geom_f, state_f.X, state_f.Q).reshape(-1, 3)
    n_f = r_f.shape[0]
    ctx_f = farfield.prepare(r_f, a=a_ff, wall=True, grid=FF_GRID, p=FF_P)
    live_f = ctx_f.id_s >= 0
    n_pad, (t_f, w_f) = ctx_f.x_s.shape[0], ctx_f.nbr.shape
    slots = (ctx_f.nbr >= 0).sum(dim=1).double()
    pairs = near_pairs(torch, ctx_f, farfield.TILE)
    F_f = torch.from_numpy(rng.standard_normal((2, n_pad, 3))).to(dev).float()
    k3_args = (ctx_f.x_s.contiguous(), ctx_f.ci_s.contiguous(),
               live_f.contiguous(), ctx_f.nbr.contiguous(), ctx_f.pairs,
               ctx_f.n_pairs)
    k3 = {}
    for k in (1, 2):
        Fk = F_f[:k].contiguous()
        U = farfield_cuda.near_sweep(ctx_f.x_s, ctx_f.ci_s, live_f, Fk,
                                     ctx_f.nbr, True, h,
                                     pairs=(ctx_f.pairs, ctx_f.n_pairs))
        torch.cuda.synchronize()
        ref = farfield._near_sweep(ctx_f.x_s.double(), ctx_f.ci_s, ctx_f.id_s,
                                   Fk.double(), ctx_f.nbr, True, h)
        err = (U.double() - ref)[:, live_f].abs().max().item()
        rel = err / ref[:, live_f].abs().max().item()
        print(f"K3 near_sweep slice n={n_f} wall=True k={k}: max|dU|={err:.3e}"
              f" max|dU|/max|U|={rel:.3e} (tol {KERNEL_TOL:g})")
        if not (rel <= KERNEL_TOL and torch.isfinite(U[:, live_f]).all()):
            raise AssertionError(f"K3 disagrees with the plain sweep at the "
                                 f"slice, k={k}: {rel}")
        del U, ref
        U1 = farfield_cuda.near_sweep_kernel(*k3_args[:3], Fk, *k3_args[3:],
                                             True, h)
        U2 = farfield_cuda.near_sweep_kernel(*k3_args[:3], Fk, *k3_args[3:],
                                             True, h)
        if not torch.equal(U1, U2):
            raise AssertionError(f"two K3 launches differ bitwise, k={k}")
        del U1, U2
        ms = cuda_ms(torch, lambda: farfield_cuda.near_sweep_kernel(
            *k3_args[:3], Fk, *k3_args[3:], True, h), 20)
        plain = cuda_ms(torch, lambda: farfield._near_sweep(
            ctx_f.x_s, ctx_f.ci_s, ctx_f.id_s, Fk, ctx_f.nbr, True, h), 2)
        # pair fields once per unordered pair (60 flop) and both
        # directions' products (2·k·30): the sweep's symmetric work
        flops = pairs // 2 * (60 + 60 * k)
        n_bytes = n_pad * (12 + 12 + 1 + 24 * k) + 4 * t_f * w_f
        k3[k] = dict(ms=ms, plain_ms=plain, flops=flops, err=err,
                     bound=bound_ms(flops, n_bytes))
        print(f"K3 time at n={n_f} (n_pad {n_pad}, {t_f} tiles, "
              f"{w_f} slots, {slots.mean().item():.1f} used on average, "
              f"{int(slots.max().item())} at most, "
              f"{int(ctx_f.n_pairs.item())} tile pairs), wall, {k} RHS: "
              f"kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e9:.1f} GFLOP/s "
              f"at {30 + 30 * k} flop over {pairs} kept ordered pairs), plain "
              f"float32 {plain:.4f} ms, bound {k3[k]['bound'][0]:.4f} ms "
              f"({k3[k]['bound'][1]}), {ms / k3[k]['bound'][0]:.2f}x the "
              f"bound")
    print("K3 launches repeat bitwise at 1 and 2 RHS")

    # ---- 7. the far-field operator (K3) vs the exact operator (K1)
    F7 = torch.from_numpy(rng.standard_normal((n_f, 3))).to(dev).float()
    ff_kw = dict(a=a_ff, eta=cfg_f.eta, wall=True, grid=FF_GRID, p=FF_P)
    U_ff = farfield.mobility_apply(F7, r_f, ctx=ctx_f, **ff_kw)
    U_ex = rpy_cuda.mobility_apply(F7, r_f, a=a_ff, eta=cfg_f.eta, wall=True)
    torch.cuda.synchronize()
    ff_rel = ((U_ff - U_ex).abs().max() / U_ex.abs().max()).item()
    ff_ms = cuda_ms(torch, lambda: farfield.mobility_apply(
        F7, r_f, ctx=ctx_f, **ff_kw), 3)
    ex_ms = cuda_ms(torch, lambda: rpy_cuda.mobility_apply(
        F7, r_f, a=a_ff, eta=cfg_f.eta, wall=True), 2)
    geo_ms = cuda_ms(torch, lambda: farfield.prepare_geometry(
        r_f, **ff_kw), 2)
    geo_f = farfield.prepare_geometry(r_f, **ff_kw)
    prep_ms = cuda_ms(torch, lambda: farfield.prepare(
        r_f, geo=geo_f, **ff_kw), 3)
    print(f"far field vs exact at n={n_f}, wall: max|dU|/max|U| = "
          f"{ff_rel:.3e} (tol {FF_OPERATOR_TOL:g}); apply {ff_ms:.3f} ms "
          f"with the setup hoisted, exact K1 apply {ex_ms:.3f} ms; lattice "
          f"build (prepare_geometry) {geo_ms:.3f} ms, position setup "
          f"(prepare with geo) {prep_ms:.3f} ms")
    if not (ff_rel <= FF_OPERATOR_TOL and torch.isfinite(U_ff).all()):
        raise AssertionError(f"the far field disagrees with the exact "
                             f"operator: {ff_rel}")
    del U_ex
    # a 2-RHS exact product at 102,480 blobs: n padded to 512 is past
    # 65,536, so the dispatch sends it to K1, as rpy_pallas.py:623 does
    F7b = torch.from_numpy(rng.standard_normal((2, n_f, 3))).to(dev).float()
    before = rpy_cuda.launch_counts()
    U7 = rpy_cuda.mobility_apply_multi(F7b, r_f, a=a_ff, eta=cfg_f.eta,
                                       wall=True)
    torch.cuda.synchronize()
    after = rpy_cuda.launch_counts()
    if not (after["pair_sweep_sym"] == before["pair_sweep_sym"] + 1
            and after["pair_sweep_ordered"] == before["pair_sweep_ordered"]
            and U7.shape == (2, n_f, 3) and torch.isfinite(U7).all()):
        raise AssertionError(f"the 2-RHS product at n={n_f} did not go "
                             f"through K1: {before} -> {after}")
    del U7
    r_fa = (r_f / a_ff).contiguous()
    P1 = rpy_cuda.pair_sweep_sym(r_fa, F7b, True, h)
    P2 = rpy_cuda.pair_sweep_ordered(r_fa, 0, r_fa, F7b, 0, True, h)
    torch.cuda.synchronize()
    k12_rel = ((P1 - P2).abs().max() / P2.abs().max()).item()
    del P1, P2
    k1_ms_f = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_sym(
        r_fa, F7b, True, h), 3)
    k2_ms_f = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_ordered(
        r_fa, 0, r_fa, F7b, 0, True, h), 3)
    print(f"2-RHS exact product at n={n_f}: dispatched to K1 (launches "
          f"{before} -> {after}); K1 vs K2 pair terms max|dU|/max|U| = "
          f"{k12_rel:.3e} (tol {KERNEL_TOL:g}); K1 {k1_ms_f:.3f} ms, K2 "
          f"{k2_ms_f:.3f} ms at 2 RHS")
    if not k12_rel <= KERNEL_TOL:
        raise AssertionError(f"K1 and K2 disagree at n={n_f}, 2 RHS: "
                             f"{k12_rel}")

    # ---- 8. the at-scale slice through K3
    gen_f = torch.Generator(device=dev).manual_seed(SEED)
    x0_f = state_f.X.clone()
    rpy_cuda.reset_launch_counts()
    farfield_cuda.reset_launch_counts()
    s_f, tr_fw = run_bd(geom_f, cfg_f, state_f, FF_WARM_STEPS,
                        generator=gen_f, force_fn=lambda s_, i: force_f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_f, tr_f = run_bd(geom_f, cfg_f, s_f, FF_TIMED_STEPS, generator=gen_f,
                       force_fn=lambda s_, i: force_f)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    counts_f = {**rpy_cuda.launch_counts(), **farfield_cuda.launch_counts()}
    res_f = torch.cat([tr_fw["residual"], tr_f["residual"]])
    iters_f = torch.cat([tr_fw["iters"], tr_f["iters"]]).double()
    steps_f = FF_WARM_STEPS + FF_TIMED_STEPS
    print(f"far-field slice: {FF_BODIES} x {FF_SHELL} = {n_f} blobs, grid "
          f"{FF_GRID}, p={FF_P}: {FF_TIMED_STEPS} steps in {wall_f:.3f} s = "
          f"{FF_TIMED_STEPS / wall_f:.4f} steps/s; max residual "
          f"{res_f.max().item():.3e}; GMRES iters per step "
          f"{iters_f.tolist()}; max noise_err "
          f"{tr_f['noise_err'].max().item():.3e}; launches {counts_f} over "
          f"{steps_f} steps ({counts_f['near_sweep'] / steps_f:.1f} K3 "
          f"per step)")
    qn_f = torch.linalg.norm(s_f.Q, dim=1)
    checks = {
        "max residual < 10 gmres_tol": res_f.max().item()
        < 10 * cfg_f.gmres_tol,
        "state finite": bool(torch.isfinite(s_f.X).all()
                             and torch.isfinite(s_f.Q).all()),
        "|q| within 1e-5 of 1": (qn_f - 1).abs().max().item() <= 1e-5,
        "bodies moved": (s_f.X - x0_f).abs().max().item() > 0,
        "K3 launched": counts_f["near_sweep"] > 0,
        "K1 not launched": counts_f["pair_sweep_sym"] == 0,
        "K2 not launched": counts_f["pair_sweep_ordered"] == 0,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"far-field slice check failed: {what}")

    # ---- 9. K3 step vs plain step at 25,620 blobs, identical draws
    gen_c = torch.Generator(device=dev).manual_seed(SEED + 2)
    draws = make_draws(geom_c, state_c, gen_c)
    s_k, aux_k = stochastic_step(geom_c, cfg_c, state_c, force_c,
                                 draws=draws)
    s_p, aux_p = stochastic_step(geom_c, cfg_c.replace(use_pallas=False),
                                 state_c, force_c, draws=draws)
    torch.cuda.synchronize()
    dX_k, dX_p = s_k.X - state_c.X, s_p.X - state_c.X
    rel = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    print(f"far-field step K3 vs plain at n={r_c64.shape[0]}: "
          f"max|dX_k - dX_p|/max|dX_p| = {rel:.3e} (tol {STEP_TOL:g}); "
          f"iters {aux_k.iters} vs {aux_p.iters}; residual "
          f"{aux_k.residual.item():.3e} vs {aux_p.residual.item():.3e}")
    if not (rel <= STEP_TOL and torch.isfinite(s_k.X).all()):
        raise AssertionError(f"K3 step disagrees with the plain step: {rel}")


    # ---- 10. K4 vs the float64 plain sweep (same fit, float64 Clenshaw)
    cfg_e, geom_e, state_e = ewald_setup(torch, dev)
    r_e = kin.blob_positions(geom_e, state_e.X, state_e.Q).reshape(-1, 3)
    n_e = r_e.shape[0]
    par_e = saddle._ewald_params(cfg_e.box, cfg_e.a, cfg_e.eta, None,
                                 cfg_e.ewald_tol)
    deg_e = par_e.cheb_A.shape[1] - 1
    print(f"periodic slice: box {par_e.box}, xi {par_e.xi:.4f}, "
          f"{len(par_e.kvecs)} wavevectors, Chebyshev degree {deg_e}, "
          f"segment edges {par_e.cheb_bounds.tolist()}")
    F_e = torch.from_numpy(rng.standard_normal((2, n_e, 3))).to(dev).float()
    k4_err = check_ewald_sweep(torch, ewald, ewald_cuda, "slice", r_e, F_e,
                               par_e)
    r_u = torch.from_numpy(rng.uniform(0, EW_BOX[0], (n_e, 3))).to(dev).float()
    check_ewald_sweep(torch, ewald, ewald_cuda, "uniform", r_u, F_e, par_e)
    par_a = ewald.make_params((9.0, 11.0, 10.0), 0.45)
    r_a = torch.from_numpy(rng.uniform(0, 1, (700, 3))
                           * np.array(par_a.box)).to(dev).float()
    check_ewald_sweep(torch, ewald, ewald_cuda, "ragged", r_a, F_e[:, :700],
                      par_a)
    # 2,049 blobs: 17 tiles, the last holding one blob, so the last row and
    # column of K4's work items are ragged
    n_r = 2049
    items_r = ewald_cuda.sweep_items(n_r)
    print(f"K4 ragged items: n={n_r}, {len(items_r)} items, last tile "
          f"{n_r - 128 * (int(items_r[:, 1].max()))} blob(s)")
    check_ewald_sweep(torch, ewald, ewald_cuda, "ragged items",
                      r_u[:n_r].contiguous(), F_e[:, :n_r].contiguous(), par_e)
    for k in (1, 2):
        Fk = F_e[:k].contiguous()
        U1 = ewald_cuda.real_sweep_kernel(r_u, Fk, par_e)
        ewald_cuda.real_sweep_kernel(r_a, Fk[:, :700].contiguous(), par_a)
        U2 = ewald_cuda.real_sweep_kernel(r_u, Fk, par_e)
        torch.cuda.synchronize()
        if not torch.equal(U1, U2):
            raise AssertionError(f"two K4 launches differ bitwise, k={k}")
    print("K4 launches repeat bitwise at 1 and 2 RHS, with another box's "
          "operator launched in between")

    # ---- 11. K4's time at the periodic slice, the wave part, the operator
    k4 = {}
    for k in (1, 2):
        Fk = F_e[:k].contiguous()
        ms = cuda_ms(torch, lambda: ewald_cuda.real_sweep_kernel(
            r_e, Fk, par_e), 20)
        plain = cuda_ms(torch, lambda: ewald.real_space_apply(
            Fk, r_e, par_e), 2)
        # per unordered pair, from the kernel's arithmetic: separation,
        # wrap, distance, segment map 36; two Clenshaw chains of one
        # subtract and one FMA per step 6·D; both applies 36 per RHS
        flops = n_e * (n_e - 1) // 2 * (36 + 6 * deg_e + 36 * k)
        n_bytes = n_e * (12 + 24 * k) + 32 * (deg_e + 1)
        k4[k] = dict(ms=ms, plain_ms=plain, bound=bound_ms(flops, n_bytes))
        print(f"K4 time at n={n_e}, degree {deg_e}, {k} RHS: kernel {ms:.4f} "
              f"ms ({flops / (ms * 1e-3) / 1e9:.1f} GFLOP/s at "
              f"{36 + 6 * deg_e + 36 * k} flop per unordered pair, "
              f"{len(ewald_cuda.sweep_items(n_e))} work items), plain "
              f"float32 {plain:.4f} ms, bound {k4[k]['bound'][0]:.4f} ms "
              f"({k4[k]['bound'][1]}), {ms / k4[k]['bound'][0]:.2f}x the "
              f"bound")
    # the same sweep over 4× the blobs (16× the pairs, ~53,000 work items
    # against the slice's 3,321): how much of the rate the slice's item
    # count leaves on the table
    n_4 = 4 * n_e
    r_4 = torch.from_numpy(rng.uniform(0, EW_BOX[0], (n_4, 3))).to(dev).float()
    F_4 = torch.from_numpy(rng.standard_normal((1, n_4, 3))).to(dev).float()
    ms_4 = cuda_ms(torch, lambda: ewald_cuda.real_sweep_kernel(
        r_4, F_4, par_e), 5)
    flops_4 = n_4 * (n_4 - 1) // 2 * (36 + 6 * deg_e + 36)
    print(f"K4 time at n={n_4} (a uniform cloud in the same box), 1 RHS: "
          f"kernel {ms_4:.4f} ms ({flops_4 / (ms_4 * 1e-3) / 1e9:.1f} GFLOP/s)")
    del r_4, F_4
    for k in (1, 2):
        Fk = F_e[:k].contiguous()
        wave_ms = cuda_ms(torch, lambda: ewald.wave_space_apply(
            Fk, r_e, par_e), 10)
        op_ms = cuda_ms(torch, lambda: ewald_cuda.mobility_apply_multi(
            Fk, r_e, par_e), 10)
        t0 = time.perf_counter()
        for _ in range(10):
            ewald_cuda.mobility_apply_multi(Fk, r_e, par_e)
        torch.cuda.synchronize()
        op_host_ms = (time.perf_counter() - t0) * 100
        print(f"Ewald operator at n={n_e}, {k} RHS: wave part {wave_ms:.4f} "
              f"ms alone, whole apply {op_ms:.4f} ms by CUDA events, "
              f"{op_host_ms:.4f} ms by the host clock: K4 + "
              f"{op_ms - k4[k]['ms']:.4f} ms")

    # ---- 12. the operator through K4 vs float64 with closed-form scalars
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the wave part needs "
                             "full float32 products")
    r_e64, F_e64 = r_e.double(), F_e.double()
    U_k = ewald_cuda.mobility_apply_multi(F_e, r_e, par_e)
    U_w = ewald.wave_space_apply(F_e, r_e, par_e)
    torch.cuda.synchronize()
    U_64 = ewald.mobility_apply_multi(F_e64, r_e64, par_e)
    U_w64 = ewald.wave_space_apply(F_e64, r_e64, par_e)
    op_rel = ((U_k.double() - U_64).abs().max() / U_64.abs().max()).item()
    wave_rel = ((U_w.double() - U_w64).abs().max()
                / U_w64.abs().max()).item()
    f1m2 = (F_e64[0] * U_k[1].double()).sum().item()
    f2m1 = (F_e64[1] * U_k[0].double()).sum().item()
    sym = abs(f1m2 - f2m1) / abs(f1m2)
    print(f"Ewald operator through K4 vs float64 closed forms at n={n_e}: "
          f"max|dU|/max|U| = {op_rel:.3e} (tol {EW_OPERATOR_TOL:g}); wave "
          f"part float32 vs float64 {wave_rel:.3e} (tol {EW_WAVE_TOL:g}); "
          f"symmetry |F1.MF2 - F2.MF1|/|F1.MF2| = {sym:.3e} "
          f"(tol {EW_SYMMETRY_TOL:g})")
    if not (op_rel <= EW_OPERATOR_TOL and wave_rel <= EW_WAVE_TOL
            and sym <= EW_SYMMETRY_TOL and torch.isfinite(U_k).all()):
        raise AssertionError("the Ewald operator through K4 fails its "
                             f"bounds: {op_rel}, {wave_rel}, {sym}")
    del U_64, U_w64, U_k, U_w

    # ---- 13. the periodic slice through K4
    gen_e = torch.Generator(device=dev).manual_seed(SEED)
    x0_e = state_e.X.clone()
    for mod in (rpy_cuda, farfield_cuda, ewald_cuda):
        mod.reset_launch_counts()
    s_e, tr_ew = run_bd(geom_e, cfg_e, state_e, EW_WARM_STEPS,
                        generator=gen_e)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_e, tr_e = run_bd(geom_e, cfg_e, s_e, EW_TIMED_STEPS, generator=gen_e)
    torch.cuda.synchronize()
    wall_e = time.perf_counter() - t0
    counts_e = {**rpy_cuda.launch_counts(), **farfield_cuda.launch_counts(),
                **ewald_cuda.launch_counts()}
    res_e = torch.cat([tr_ew["residual"], tr_e["residual"]])
    iters_e = torch.cat([tr_ew["iters"], tr_e["iters"]]).double()
    steps_e = EW_WARM_STEPS + EW_TIMED_STEPS
    qn_e = torch.linalg.norm(s_e.Q, dim=1)
    print(f"periodic slice: {N_BODIES} x {SHELL} = {n_e} blobs, box {EW_BOX}, "
          f"ewald_tol {EW_TOL:g}: {EW_TIMED_STEPS} steps in {wall_e:.3f} s = "
          f"{EW_TIMED_STEPS / wall_e:.4f} steps/s; max residual "
          f"{res_e.max().item():.3e}; GMRES iters per step "
          f"{iters_e.tolist()}; max noise_err "
          f"{tr_e['noise_err'].max().item():.3e}; max||q|-1| "
          f"{(qn_e - 1).abs().max().item():.3e}; launches {counts_e} over "
          f"{steps_e} steps ({counts_e['ewald_real_sweep'] / steps_e:.1f} K4 "
          f"per step)")
    checks = {
        "max residual < 10 gmres_tol": res_e.max().item()
        < 10 * cfg_e.gmres_tol,
        "state finite": bool(torch.isfinite(s_e.X).all()
                             and torch.isfinite(s_e.Q).all()),
        "|q| within 1e-5 of 1": (qn_e - 1).abs().max().item() <= 1e-5,
        "bodies moved": (s_e.X - x0_e).abs().max().item() > 0,
        "K4 launched": counts_e["ewald_real_sweep"] > 0,
        "K1 not launched": counts_e["pair_sweep_sym"] == 0,
        "K2 not launched": counts_e["pair_sweep_ordered"] == 0,
        "K3 not launched": counts_e["near_sweep"] == 0,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"periodic slice check failed: {what}")

    # ---- 14. K4 step vs plain step, identical draws
    zero_e = torch.zeros((N_BODIES, 6), dtype=torch.float32, device=dev)
    draws = make_draws(geom_e, s_e, gen_e)
    s_k, aux_k = stochastic_step(geom_e, cfg_e, s_e, zero_e, draws=draws)
    s_p, aux_p = stochastic_step(geom_e, cfg_e.replace(use_pallas=False),
                                 s_e, zero_e, draws=draws)
    torch.cuda.synchronize()
    dX_k, dX_p = s_k.X - s_e.X, s_p.X - s_e.X
    rel = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    print(f"periodic step K4 vs plain: max|dX_k - dX_p|/max|dX_p| = "
          f"{rel:.3e} (tol {STEP_TOL:g}); iters {aux_k.iters} vs "
          f"{aux_p.iters}; residual {aux_k.residual.item():.3e} vs "
          f"{aux_p.residual.item():.3e}")
    if not (rel <= STEP_TOL and torch.isfinite(s_k.X).all()):
        raise AssertionError(f"K4 step disagrees with the plain step: {rel}")

    # ---- 15. P: the FMA probe vs its plain version, then the card's rate
    n_p = 10240
    x_p = torch.from_numpy(rng.uniform(0.5, 1.5, n_p)).to(dev).float()
    c_p = torch.from_numpy(rng.uniform(0.5, 1.5, n_p)).to(dev).float()
    one_p = torch.ones(n_p, dtype=torch.float32, device=dev)
    p_err = None
    for label, x_, c_, tol in (("random", x_p, c_p, P_TOL),
                               ("ones", one_p, one_p, P_TOL_ONES)):
        out = roofline.fma_chain(x_, c_)
        torch.cuda.synchronize()
        ref = roofline.fma_chain_plain(x_.double(), c_.double())
        pl32 = roofline.fma_chain_plain(x_, c_)
        rel = ((out.double() - ref).abs() / ref.abs()).max().item()
        rel_pl = ((pl32.double() - ref).abs() / ref.abs()).max().item()
        print(f"P fma_peak {label} n={n_p}: kernel vs float64 plain max rel "
              f"{rel:.3e} (tol {tol:g}); float32 plain vs float64 plain "
              f"{rel_pl:.3e}")
        if not (rel <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"P disagrees with its plain version on "
                                 f"{label}: {rel}")
        if p_err is None:
            p_err = (out.double() - ref).abs().max().item()
    p_plain_ms = cuda_ms(torch, lambda: roofline.fma_chain_plain(
        one_p, one_p), 2)
    roofline.reset_launch_counts()
    p_ms, p_tflops = roofline.measure_fp32_peak(n=n_p, device=dev)
    p_launches = roofline.launch_counts()["fma_peak"]
    p_flops = n_p * n_p * (2 * roofline.CHAIN + 2)
    bp = bound_ms(p_flops, 12 * n_p)
    print(f"P time at n={n_p}, chain {roofline.CHAIN}: kernel {p_ms:.4f} ms = "
          f"{p_tflops:.2f} TFLOP/s measured FP32 FMA rate, "
          f"{100 * p_tflops * 1e12 / PEAK_FP32_FLOPS:.1f}% of the nominal "
          f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s; plain float32 "
          f"{p_plain_ms:.4f} ms; bound {bp[0]:.4f} ms ({bp[1]}); "
          f"{p_launches} launches")
    if p_launches <= 0:
        raise AssertionError("measure_fp32_peak launched no kernel")

    # ---- 16. K1 at 409,600 blobs (grouped tiles, O(n) scratch); K4 over
    # grouped tiles and its bitwise repeat at the periodic slice
    # a cloud at the dense slice's blob density (its bounding box), in a
    # square slab of its heights above the wall
    lo, hi = r_slice.min(dim=0).values, r_slice.max(dim=0).values
    dens = n / torch.prod(hi - lo).item()
    z_lo, z_hi = lo[2].item(), hi[2].item()
    side = (SCALE_N / (dens * (z_hi - z_lo))) ** 0.5
    r_s = torch.from_numpy(rng.uniform([0, 0, z_lo], [side, side, z_hi],
                                       (SCALE_N, 3))).to(dev).float()
    r_sa = (r_s / a).contiguous()
    F_s = torch.from_numpy(rng.standard_normal((2, SCALE_N, 3))).to(
        dev).float()
    rows_s = torch.from_numpy(np.sort(rng.choice(SCALE_N, SCALE_ROWS,
                                                 replace=False))).to(dev)
    ids_s = torch.arange(SCALE_N, device=dev)
    groups_s = tiles.sweep_groups(SCALE_N)
    k1_scale = {}
    for k in (1, 2):
        Fk = F_s[:k].contiguous()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        U = rpy_cuda.pair_sweep_sym(r_sa, Fk, True, h)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        scratch = 2 * 4 * int(np.prod(tiles.partial_shape(SCALE_N, k)))
        ref = rpy.pair_sum(r_sa[rows_s].double(), rows_s, r_sa.double(),
                           ids_s, Fk.double(), wall=True, row_tile=16,
                           h_floor=h)
        err = (U[:, rows_s].double() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        U2 = rpy_cuda.pair_sweep_sym(r_sa, Fk, True, h)
        torch.cuda.synchronize()
        same = torch.equal(U, U2)
        del U, U2, ref
        ms = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_sym(
            r_sa, Fk, True, h), 2)
        T_s = groups_s[0]
        old_bytes = 2 * 4 * (T_s * (T_s + 1) // 2) * 3 * k * 128
        k1_scale[k] = dict(ms=ms, err=err, rel=rel, scratch_bytes=scratch,
                           peak_bytes=peak)
        print(f"K1 at n={SCALE_N} (a cloud at the dense slice's density "
              f"{dens:.1f} blobs per unit volume, {side:.1f} x {side:.1f} x "
              f"[{z_lo:.2f}, {z_hi:.2f}], wall), {k} RHS: {T_s} tiles in "
              f"{groups_s[2]} groups of at most {groups_s[1]}, {groups_s[3]} "
              f"blocks;"
              f" on {SCALE_ROWS} sampled rows max|dU|={err:.3e} "
              f"max|dU|/max|U|={rel:.3e} (tol {KERNEL_TOL:g}); two launches "
              f"bitwise equal: {same}; {ms:.2f} ms; scratch "
              f"{scratch / 1e9:.3f} GB = "
              f"{scratch / 4 / (3 * k * SCALE_N):.1f} floats per blob and "
              f"RHS component (one partial an item would take "
              f"{old_bytes / 1e9:.1f} GB); torch.cuda.max_memory_allocated "
              f"over the launch {peak / 1e9:.3f} GB")
        if not (rel <= KERNEL_TOL and same
                and peak <= scratch + 12 * k * SCALE_N + 64 * 2**20):
            raise AssertionError(f"K1 at n={SCALE_N}, k={k}: rel {rel}, "
                                 f"bitwise {same}, peak {peak} bytes")
    del r_s, r_sa, F_s
    r_g = torch.from_numpy(rng.uniform(0, EW_BOX[0], (K4_GROUPED_N, 3))).to(
        dev).float()
    F_g = torch.from_numpy(rng.standard_normal((2, K4_GROUPED_N, 3))).to(
        dev).float()
    print(f"K4 grouped: n={K4_GROUPED_N}, (tiles, most tiles a group, "
          f"groups, blocks) = {tiles.sweep_groups(K4_GROUPED_N)}")
    rows_g = torch.from_numpy(np.sort(rng.choice(
        K4_GROUPED_N, SCALE_ROWS, replace=False))).to(dev)
    check_ewald_sweep(torch, ewald, ewald_cuda, "grouped", r_g, F_g, par_e,
                      rows=rows_g)
    for k in (1, 2):
        for r_, F_ in ((r_g, F_g), (r_e, F_e)):
            Fk = F_[:k].contiguous()
            U1 = ewald_cuda.real_sweep_kernel(r_, Fk, par_e)
            U2 = ewald_cuda.real_sweep_kernel(r_, Fk, par_e)
            torch.cuda.synchronize()
            if not torch.equal(U1, U2):
                raise AssertionError(f"two K4 launches differ bitwise at "
                                     f"n={r_.shape[0]}, k={k}")
    del r_g, F_g
    print("K4 launches repeat bitwise at 1 and 2 RHS at the periodic slice "
          f"and at n={K4_GROUPED_N}")

    # ---- 17. the settled solve: block_free against RAS, one RHS
    cfg_s, geom_s, state_s, force_fn_s = settled_setup(torch, dev)
    r_st = kin.blob_positions(geom_s, state_s.X, state_s.Q).reshape(-1, 3)
    n_st = r_st.shape[0]
    ops_s = saddle.geometry_ops(geom_s, state_s)
    # the RHS of a deterministic settled step: no slip, the settled forces
    slip_s = torch.zeros((n_st, 3), dtype=torch.float32, device=dev)
    f_s = force_fn_s(state_s, 0)
    solve = {}
    for mode in ("block_free", "ras"):
        cfg_m = cfg_s.replace(pc_mode=mode, gmres_tol=ST_SOLVE_TOL,
                              gmres_maxiter=300)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_m = solvers.solve_saddle(ops_s, cfg_m, slip_s, f_s)
        torch.cuda.synchronize()
        solve[mode] = (res_m, time.perf_counter() - t0)
    (res_bf, t_bf), (res_ras, t_ras) = solve["block_free"], solve["ras"]
    du = ((res_ras.U - res_bf.U).abs().max() / res_bf.U.abs().max()).item()
    print(f"settled solve at the checkpoint's geometry (n={n_st}), float32, "
          f"slip 0 and the settled forces, gmres_tol {ST_SOLVE_TOL:g}: "
          f"block_free {res_bf.iters} iterations "
          f"(residual {res_bf.residual.item():.3e}, {t_bf * 1e3:.1f} ms), RAS "
          f"{res_ras.iters} (residual {res_ras.residual.item():.3e}, "
          f"{t_ras * 1e3:.1f} ms, the halo build included); "
          f"max|U_ras - U_bf|/max|U_bf| = {du:.3e} (tol "
          f"{10 * ST_SOLVE_TOL:g})")
    # both solves converged as far as float32 takes them: each residual
    # below 10·gmres_tol, the bound every slice holds its steps to
    if not (res_ras.iters < res_bf.iters and du <= 10 * ST_SOLVE_TOL
            and res_ras.residual.item() < 10 * ST_SOLVE_TOL
            and res_bf.residual.item() < 10 * ST_SOLVE_TOL):
        raise AssertionError("the settled solve: RAS must take fewer "
                             "iterations than block_free and agree with it")

    # ---- 18. the settled slice through the kernels
    gen_s = torch.Generator(device=dev).manual_seed(SEED)
    x0_s = state_s.X.clone()
    for mod in (rpy_cuda, farfield_cuda, ewald_cuda):
        mod.reset_launch_counts()
    st, tr_sw = run_bd(geom_s, cfg_s, state_s, ST_WARM_STEPS,
                       generator=gen_s, force_fn=force_fn_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, tr_s = run_bd(geom_s, cfg_s, st, ST_TIMED_STEPS, generator=gen_s,
                      force_fn=force_fn_s)
    torch.cuda.synchronize()
    wall_st = time.perf_counter() - t0
    counts_s = {**rpy_cuda.launch_counts(), **farfield_cuda.launch_counts(),
                **ewald_cuda.launch_counts()}
    steps_s = ST_WARM_STEPS + ST_TIMED_STEPS
    res_s = torch.cat([tr_sw["residual"], tr_s["residual"]])
    iters_s = torch.cat([tr_sw["iters"], tr_s["iters"]]).double()
    qn_s = torch.linalg.norm(st.Q, dim=1)
    settled = dict(steps_per_s=ST_TIMED_STEPS / wall_st,
                   mean_iters=tr_s["iters"].double().mean().item(),
                   max_iters=int(tr_s["iters"].max().item()),
                   max_noise_err=tr_s["noise_err"].max().item(),
                   k1_per_step=counts_s["pair_sweep_sym"] / steps_s,
                   k2_per_step=counts_s["pair_sweep_ordered"] / steps_s)
    print(f"settled slice: {n_st} blobs from {os.path.basename(SETTLED_CKPT)}"
          f", RAS halo {cfg_s.pc_halo:g}a / {cfg_s.pc_halo_max}, adaptive "
          f"Lanczos {cfg_s.lanczos_iters}-{cfg_s.lanczos_max_iters}: "
          f"{ST_TIMED_STEPS} steps in {wall_st:.3f} s = "
          f"{settled['steps_per_s']:.4f} steps/s; GMRES iterations mean "
          f"{settled['mean_iters']:.2f}, max {settled['max_iters']} (per "
          f"step {iters_s.tolist()}; the JAX package's TPU records, another "
          f"draw: {TPU_MEAN_ITERS['3e-4']} at gmres_tol 3e-4, "
          f"{TPU_MEAN_ITERS['1e-4']} at 1e-4); max residual "
          f"{res_s.max().item():.3e}; max noise_err "
          f"{settled['max_noise_err']:.3e}; max||q|-1| "
          f"{(qn_s - 1).abs().max().item():.3e}; launches {counts_s} over "
          f"{steps_s} steps ({settled['k1_per_step']:.1f} K1, "
          f"{settled['k2_per_step']:.1f} K2 a step)")
    checks = {
        "every residual < 10 gmres_tol": res_s.max().item()
        < 10 * cfg_s.gmres_tol,
        "state finite": bool(torch.isfinite(st.X).all()
                             and torch.isfinite(st.Q).all()),
        "|q| within 1e-5 of 1": (qn_s - 1).abs().max().item() <= 1e-5,
        "bodies moved": (st.X - x0_s).abs().max().item() > 0,
        "K1 launched": counts_s["pair_sweep_sym"] > 0,
        "K2 launched": counts_s["pair_sweep_ordered"] > 0,
        "K3 not launched": counts_s["near_sweep"] == 0,
        "K4 not launched": counts_s["ewald_real_sweep"] == 0,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"settled slice check failed: {what}")

    # ---- 19. settled kernel step vs plain step, identical draws
    draws = make_draws(geom_s, st, gen_s)
    f_st = force_fn_s(st, 0)
    s_k, aux_k = stochastic_step(geom_s, cfg_s, st, f_st, draws=draws)
    s_p, aux_p = stochastic_step(geom_s, cfg_s.replace(use_pallas=False), st,
                                 f_st, draws=draws)
    torch.cuda.synchronize()
    dX_k, dX_p = s_k.X - st.X, s_p.X - st.X
    rel = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    print(f"settled step kernel vs plain: max|dX_k - dX_p|/max|dX_p| = "
          f"{rel:.3e} (tol {STEP_TOL:g}); iters {aux_k.iters} vs "
          f"{aux_p.iters}; residual {aux_k.residual.item():.3e} vs "
          f"{aux_p.residual.item():.3e}")
    if not (rel <= STEP_TOL and torch.isfinite(s_k.X).all()):
        raise AssertionError(f"settled kernel step disagrees with the plain "
                             f"step: {rel}")

    # ---- 20. the step timer's split on all four slices, and its cost
    splits = [
        step_split(torch, profiling, "dense", lambda k: run_bd(
            geom, cfg, s, k, generator=gen, force_fn=lambda s_, i: force),
            SPLIT_STEPS["dense"]),
        step_split(torch, profiling, "far-field", lambda k: run_bd(
            geom_f, cfg_f, s_f, k, generator=gen_f,
            force_fn=lambda s_, i: force_f), SPLIT_STEPS["far-field"]),
        step_split(torch, profiling, "periodic", lambda k: run_bd(
            geom_e, cfg_e, s_e, k, generator=gen_e), SPLIT_STEPS["periodic"]),
        step_split(torch, profiling, "settled", lambda k: run_bd(
            geom_s, cfg_s, st, k, generator=gen_s, force_fn=force_fn_s),
            SPLIT_STEPS["settled"]),
    ]
    cfg_fm, geom_fm, state_fm, force_fn_fm = film_setup(torch, dev,
                                                        FILM_SHELLS)
    gen_fm = torch.Generator(device=dev).manual_seed(SEED)
    splits.append(step_split(
        torch, profiling, f"film (image_shells {FILM_SHELLS})",
        lambda k: run_bd(geom_fm, cfg_fm, state_fm, k, generator=gen_fm,
                         force_fn=force_fn_fm), SPLIT_STEPS["film"]))
    cost = {}
    for label in ("off", "on", "on", "off"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (profiling.StepTimer() if label == "on"
              else contextlib.nullcontext()):
            run_bd(geom, cfg, s, 4, generator=gen,
                   force_fn=lambda s_, i: force)
            torch.cuda.synchronize()
        cost.setdefault(label, []).append(4 / (time.perf_counter() - t0))
    print(f"step timer cost, dense slice, 4 steps a run in turns (off, on, "
          f"on, off): {cost['off']} steps/s without it, {cost['on']} with it")

    # ---- 21. K1 and K2's box forms vs the float64 plain sweep, their times
    a_fm = cfg_fm.a
    r_fm = kin.blob_positions(geom_fm, state_fm.X, state_fm.Q).reshape(-1, 3)
    n_fm = r_fm.shape[0]
    # the box in units of a as the kernels see it (float32), given to the
    # plain sweep too
    box_fm = tuple(float(np.float32(b / a_fm)) for b in cfg_fm.box)
    r_fma = (r_fm / a_fm).contiguous()
    rng_fm = np.random.default_rng(SEED + 7)
    F_fm = torch.from_numpy(rng_fm.standard_normal((2, n_fm, 3))).to(
        dev).float()
    box_errs = check_box_sweeps(torch, rpy, rpy_cuda, "film slice", r_fma,
                                F_fm, box_fm, h)
    L_fm = cfg_fm.box[0]
    ragged_fm = torch.from_numpy(rng_fm.uniform(
        [-0.2 * L_fm, -0.2 * L_fm, 0.3 * a_fm],
        [1.2 * L_fm, 1.2 * L_fm, 8 * a_fm], (1000, 3)) / a_fm).to(dev).float()
    check_box_sweeps(torch, rpy, rpy_cuda, "ragged", ragged_fm,
                     F_fm[:, :1000].contiguous(), box_fm, h)
    # K1's grouped kernel: a cloud at the film's blob density and heights
    z_fm = r_fma[:, 2]
    L_g = L_fm / a_fm * (FILM_GROUPED_N / n_fm) ** 0.5
    box_g = (float(np.float32(L_g)), float(np.float32(L_g)))
    r_g = torch.from_numpy(rng_fm.uniform(
        [0, 0, z_fm.min().item()], [L_g, L_g, z_fm.max().item()],
        (FILM_GROUPED_N, 3))).to(dev).float()
    F_g = torch.from_numpy(rng_fm.standard_normal((2, FILM_GROUPED_N, 3))).to(
        dev).float()
    rows_g = torch.from_numpy(np.sort(rng_fm.choice(
        FILM_GROUPED_N, SCALE_ROWS, replace=False))).to(dev)
    print(f"K1 grouped in the box: n={FILM_GROUPED_N}, (tiles, most tiles a "
          f"group, groups, blocks) = {tiles.sweep_groups(FILM_GROUPED_N)}")
    check_box_sweeps(torch, rpy, rpy_cuda, "grouped", r_g, F_g, box_g, h,
                     kernels=("K1",), rows=rows_g)
    del r_g, F_g
    for S in (0, FILM_SHELLS):
        args = rpy_cuda.box_args(box_fm, S)
        for k in (1, 2):
            Fk = F_fm[:k].contiguous()
            for fn in (lambda: rpy_cuda.pair_sweep_sym(r_fma, Fk, True, h,
                                                       box=args),
                       lambda: rpy_cuda.pair_sweep_ordered(
                           r_fma, 0, r_fma, Fk, 0, True, h, box=args)):
                U1, U2 = fn(), fn()
                torch.cuda.synchronize()
                if not torch.equal(U1, U2):
                    raise AssertionError(f"two box-form launches differ "
                                         f"bitwise, image_shells={S}, k={k}")
    print("K1 and K2 box-form launches repeat bitwise at image_shells 0 and "
          f"{FILM_SHELLS}, 1 and 2 RHS")
    ids_fm = torch.arange(n_fm, device=dev)
    film_k = {}
    # K1 at 1 RHS (the GMRES and RFD products), K2 at 2 (the noise)
    for name, k in (("K1", 1), ("K2", 2)):
        Fk = F_fm[:k].contiguous()
        for S in (0, FILM_SHELLS):
            args = rpy_cuda.box_args(box_fm, S)
            if name == "K1":
                ms = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_sym(
                    r_fma, Fk, True, h, box=args), 10)
            else:
                ms = cuda_ms(torch, lambda: rpy_cuda.pair_sweep_ordered(
                    r_fma, 0, r_fma, Fk, 0, True, h, box=args), 10)
            plain = cuda_ms(torch, lambda: rpy.pair_sum(
                r_fma, ids_fm, r_fma, ids_fm, Fk, wall=True, h_floor=h,
                box=box_fm, image_shells=S), 1)
            n_img = (2 * S + 1) ** 2
            flops = n_img * n_fm * n_fm * (60 + 60 * k) // 2
            b = bound_ms(flops, n_fm * (12 + 24 * k))
            film_k[name, S] = dict(ms=ms, plain_ms=plain, bound=b,
                                   err=box_errs[name, S, k])
            print(f"{name} box form at the film slice n={n_fm}, "
                  f"image_shells={S} ({n_img} offsets), {k} RHS: kernel "
                  f"{ms:.4f} ms ({flops / (ms * 1e-3) / 1e9:.1f} GFLOP/s), "
                  f"plain float32 {plain:.4f} ms, bound {b[0]:.4f} ms "
                  f"({b[1]}), {ms / b[0]:.2f}x the bound")

    # ---- 22. the film slice through the kernels, image_shells 2 then 0
    film = {}
    film_states = {}
    for S in (FILM_SHELLS, 0):
        cfg_S = cfg_fm.replace(image_shells=S)
        gen_S = torch.Generator(device=dev).manual_seed(SEED)
        for mod in (rpy_cuda, farfield_cuda, ewald_cuda):
            mod.reset_launch_counts()
        sS, tr_w = run_bd(geom_fm, cfg_S, state_fm, FILM_WARM_STEPS,
                          generator=gen_S, force_fn=force_fn_fm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sS, tr = run_bd(geom_fm, cfg_S, sS, FILM_TIMED_STEPS, generator=gen_S,
                        force_fn=force_fn_fm)
        torch.cuda.synchronize()
        wall_S = time.perf_counter() - t0
        counts_S = {**rpy_cuda.launch_counts(),
                    **farfield_cuda.launch_counts(),
                    **ewald_cuda.launch_counts()}
        steps_S = FILM_WARM_STEPS + FILM_TIMED_STEPS
        res_S = torch.cat([tr_w["residual"], tr["residual"]])
        iters_S = torch.cat([tr_w["iters"], tr["iters"]]).double()
        qn_S = torch.linalg.norm(sS.Q, dim=1)
        film[S] = dict(steps_per_s=FILM_TIMED_STEPS / wall_S,
                       mean_iters=iters_S.mean().item(),
                       max_iters=int(iters_S.max().item()),
                       max_residual=res_S.max().item(),
                       k1=counts_S["pair_sweep_sym"],
                       k2=counts_S["pair_sweep_ordered"],
                       k1_per_step=counts_S["pair_sweep_sym"] / steps_S,
                       k2_per_step=counts_S["pair_sweep_ordered"] / steps_S)
        film_states[S] = (sS, gen_S)
        print(f"film slice: {n_fm} blobs in the {cfg_fm.box} box, "
              f"image_shells={S}: {FILM_TIMED_STEPS} steps in {wall_S:.3f} s"
              f" = {film[S]['steps_per_s']:.4f} steps/s; GMRES iterations "
              f"mean {film[S]['mean_iters']:.2f}, max {film[S]['max_iters']} "
              f"(per step {iters_S.tolist()}); max residual "
              f"{film[S]['max_residual']:.3e}; max noise_err "
              f"{tr['noise_err'].max().item():.3e}; max||q|-1| "
              f"{(qn_S - 1).abs().max().item():.3e}; launches {counts_S} "
              f"over {steps_S} steps ({film[S]['k1_per_step']:.1f} K1, "
              f"{film[S]['k2_per_step']:.1f} K2 a step)")
        checks = {
            "every residual < 10 gmres_tol": film[S]["max_residual"]
            < 10 * cfg_S.gmres_tol,
            "state finite": bool(torch.isfinite(sS.X).all()
                                 and torch.isfinite(sS.Q).all()),
            "|q| within 1e-5 of 1": (qn_S - 1).abs().max().item() <= 1e-5,
            "bodies moved": (sS.X - state_fm.X).abs().max().item() > 0,
            "K1 launched": counts_S["pair_sweep_sym"] > 0,
            "K2 launched": counts_S["pair_sweep_ordered"] > 0,
            "K3 not launched": counts_S["near_sweep"] == 0,
            "K4 not launched": counts_S["ewald_real_sweep"] == 0,
        }
        for what, ok in checks.items():
            if not ok:
                raise AssertionError(f"film slice check failed "
                                     f"(image_shells={S}): {what}")

    # ---- 23. film step through the kernels vs the plain float32 sweep, at
    # the slice's state after phase 22 (off the lattice, whose blob pairs
    # lie exactly on the seams; a 4-body film in a (5, 5) box has an
    # indefinite operator even at image_shells 2, PERF.md §6)
    s_23, gen_23 = film_states[FILM_SHELLS]
    draws = make_draws(geom_fm, s_23, gen_23)
    f_23 = force_fn_fm(s_23, 0)
    t0 = time.perf_counter()
    s_k, aux_k = stochastic_step(geom_fm, cfg_fm, s_23, f_23, draws=draws)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_p, aux_p = stochastic_step(geom_fm, cfg_fm.replace(use_pallas=False),
                                 s_23, f_23, draws=draws)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    dX_k, dX_p = s_k.X - s_23.X, s_p.X - s_23.X
    rel = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    print(f"film step (image_shells {FILM_SHELLS}) kernel vs plain at the "
          f"slice's state after phase 22, n={n_fm}: "
          f"max|dX_k - dX_p|/max|dX_p| = {rel:.3e} (tol {STEP_TOL:g}); "
          f"iters {aux_k.iters} vs {aux_p.iters}; residual "
          f"{aux_k.residual.item():.3e} vs {aux_p.residual.item():.3e}; "
          f"{t_k:.2f} s vs {t_p:.2f} s")
    if not (rel <= STEP_TOL and torch.isfinite(s_k.X).all()):
        raise AssertionError(f"film kernel step disagrees with the plain "
                             f"step: {rel}")
    film_step_check = {"rel": rel, "kernel_s": t_k, "plain_s": t_p}

    # ---- 24. K3's box form at the far-field film slice and edge clouds
    cfg_b, geom_b, state_b, force_b = farfield_setup(
        torch, dev, FF_BODIES, side=FB_SIDE, box=FB_BOX, grid=FB_GRID)
    a_b = cfg_b.a
    r_b = kin.blob_positions(geom_b, state_b.X, state_b.Q).reshape(-1, 3)
    n_b = r_b.shape[0]
    fb_kw = dict(a=a_b, eta=cfg_b.eta, wall=True, grid=FB_GRID, p=FF_P,
                 box=FB_BOX, image_shells=FB_SHELLS)
    ctx_b = farfield.prepare(r_b, **fb_kw)
    # the box in units of a as the kernel sees it (float32), given to the
    # float64 plain sweep too
    box_b = tuple(float(np.float32(b / a_b)) for b in FB_BOX)
    wrap_b = FB_GRID[:2]
    rng_b = np.random.default_rng(SEED + 8)
    k3b_err = check_near_forms(torch, farfield, farfield_cuda, "film slice",
                               ctx_b, rng_b, walls=(True,), box=box_b,
                               wrap=wrap_b, poly=False)
    for label, (r_e, box_e, grid_e) in film_near_clouds().items():
        ctx_e = farfield.prepare(torch.from_numpy(r_e).to(dev), wall=True,
                                 grid=grid_e, p=3, box=box_e, image_shells=1)
        check_near_forms(torch, farfield, farfield_cuda, label, ctx_e, rng_b,
                         walls=(True,),
                         box=tuple(float(np.float32(b)) for b in box_e),
                         wrap=grid_e[:2], poly=False)
    live_b = ctx_b.id_s >= 0
    n_pad_b, (t_b, w_b) = ctx_b.x_s.shape[0], ctx_b.nbr.shape
    slots_b = (ctx_b.nbr >= 0).sum(dim=1).double()
    pairs_b = near_pairs(torch, ctx_b, farfield.TILE, wrap_cells=wrap_b)
    F_b = torch.from_numpy(rng_b.standard_normal((2, n_pad_b, 3))).to(
        dev).float()
    k3b = {}
    for k in (1, 2):
        args = (ctx_b.x_s, ctx_b.ci_s, live_b, F_b[:k].contiguous(),
                ctx_b.nbr, ctx_b.pairs, ctx_b.n_pairs, True, h, box_b,
                wrap_b)
        ms = cuda_ms(torch, lambda: farfield_cuda.near_sweep_kernel(*args),
                     20)
        plain = cuda_ms(torch, lambda: farfield._near_sweep(
            ctx_b.x_s, ctx_b.ci_s, ctx_b.id_s, F_b[:k], ctx_b.nbr, True, h,
            box_n=box_b, wrap_xy=wrap_b), 2)
        # as the open form: pair fields once per unordered pair and both
        # directions' products, the wrap's few operations not counted
        flops = pairs_b // 2 * (60 + 60 * k)
        n_bytes = n_pad_b * (12 + 12 + 1 + 24 * k) + 4 * t_b * w_b
        k3b[k] = dict(ms=ms, plain_ms=plain, flops=flops,
                      err=k3b_err[True, k],
                      bound=bound_ms(flops, n_bytes))
        print(f"K3 box form time at the film slice n={n_b} (n_pad "
              f"{n_pad_b}, {t_b} tiles, {w_b} slots, "
              f"{slots_b.mean().item():.1f} used on average, "
              f"{int(slots_b.max().item())} at most, "
              f"{int(ctx_b.n_pairs.item())} tile pairs), {k} RHS: kernel "
              f"{ms:.4f} ms ({flops / (ms * 1e-3) / 1e9:.1f} GFLOP/s over "
              f"{pairs_b} kept ordered pairs), plain float32 {plain:.4f} ms,"
              f" bound {k3b[k]['bound'][0]:.4f} ms ({k3b[k]['bound'][1]}), "
              f"{ms / k3b[k]['bound'][0]:.2f}x the bound; the open form at "
              f"the far-field slice (phase 6) {k3[k]['ms']:.4f} ms, "
              f"{k3[k]['ms'] / k3[k]['bound'][0]:.2f}x its bound")

    # ---- 25. the film operator vs the exact S = 6 image sweep; the slice
    F25 = torch.from_numpy(rng_b.standard_normal((n_b, 3))).to(dev).float()
    U_fb = farfield.mobility_apply(F25, r_b, ctx=ctx_b, **fb_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U_eb = rpy_cuda.mobility_apply(F25, r_b, a=a_b, eta=cfg_b.eta, wall=True,
                                   box=FB_BOX, image_shells=FB_SHELLS)
    torch.cuda.synchronize()
    ex_b_s = time.perf_counter() - t0
    fb_rel = ((U_fb - U_eb).abs().max() / U_eb.abs().max()).item()
    del U_eb
    fb_same = torch.equal(U_fb, farfield.mobility_apply(F25, r_b, ctx=ctx_b,
                                                        **fb_kw))
    fb_ms = cuda_ms(torch, lambda: farfield.mobility_apply(
        F25, r_b, ctx=ctx_b, **fb_kw), 3)
    torch.cuda.reset_peak_memory_stats()
    geo_b_ms = cuda_ms(torch, lambda: farfield.prepare_geometry(
        r_b, **fb_kw), 2)
    geo_b_peak = torch.cuda.max_memory_allocated()
    geo_b = farfield.prepare_geometry(r_b, **fb_kw)
    prep_b_ms = cuda_ms(torch, lambda: farfield.prepare(
        r_b, geo=geo_b, **fb_kw), 3)
    print(f"far-field film vs the exact image sweep (K1's box form at "
          f"image_shells {FB_SHELLS} with the tail, and the self images) at "
          f"n={n_b}, box {FB_BOX}, grid {FB_GRID}, p={FF_P}: max|dU|/max|U| "
          f"= {fb_rel:.3e} (tol {FF_OPERATOR_TOL:g}); two products bitwise "
          f"equal: {fb_same}; apply {fb_ms:.3f} ms "
          f"with the setup hoisted, the exact product {ex_b_s:.2f} s; "
          f"lattice build (prepare_geometry, {(2 * FB_SHELLS + 1) ** 2} "
          f"shifts) {geo_b_ms:.3f} ms, peak memory "
          f"{geo_b_peak / 1e9:.3f} GB, lattice "
          f"{geo_b.khat_wall.numel() * geo_b.khat_wall.element_size() / 1e6:.1f}"
          f" MB; position setup (prepare with geo) {prep_b_ms:.3f} ms")
    if not (fb_rel <= FF_OPERATOR_TOL and torch.isfinite(U_fb).all()
            and fb_same):
        raise AssertionError(f"the far-field film disagrees with the exact "
                             f"image sweep ({fb_rel}) or with itself "
                             f"({fb_same})")
    del U_fb, geo_b
    gen_b = torch.Generator(device=dev).manual_seed(SEED)
    x0_b = state_b.X.clone()
    for mod in (rpy_cuda, farfield_cuda, ewald_cuda):
        mod.reset_launch_counts()
    s_b, tr_bw = run_bd(geom_b, cfg_b, state_b, FF_WARM_STEPS,
                        generator=gen_b, force_fn=lambda s_, i: force_b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_b, tr_b = run_bd(geom_b, cfg_b, s_b, FF_TIMED_STEPS, generator=gen_b,
                       force_fn=lambda s_, i: force_b)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    counts_b = {**rpy_cuda.launch_counts(), **farfield_cuda.launch_counts(),
                **ewald_cuda.launch_counts()}
    steps_b = FF_WARM_STEPS + FF_TIMED_STEPS
    res_b = torch.cat([tr_bw["residual"], tr_b["residual"]])
    iters_b = torch.cat([tr_bw["iters"], tr_b["iters"]]).double()
    qn_b = torch.linalg.norm(s_b.Q, dim=1)
    film_ff = dict(steps_per_s=FF_TIMED_STEPS / wall_b,
                   iters=iters_b.tolist(), max_residual=res_b.max().item(),
                   k3=counts_b["near_sweep"],
                   k3_per_step=counts_b["near_sweep"] / steps_b,
                   operator_rel=fb_rel, lattice_build_ms=geo_b_ms,
                   lattice_build_peak_bytes=geo_b_peak, apply_ms=fb_ms,
                   position_setup_ms=prep_b_ms)
    print(f"far-field film slice: {FF_BODIES} x {FF_SHELL} = {n_b} blobs in "
          f"the {FB_BOX} box, grid {FB_GRID}, p={FF_P}, image_shells "
          f"{FB_SHELLS}: {FF_TIMED_STEPS} steps in {wall_b:.3f} s = "
          f"{film_ff['steps_per_s']:.4f} steps/s; GMRES iters per step "
          f"{iters_b.tolist()}; max residual {res_b.max().item():.3e}; max "
          f"noise_err {tr_b['noise_err'].max().item():.3e}; max||q|-1| "
          f"{(qn_b - 1).abs().max().item():.3e}; launches {counts_b} over "
          f"{steps_b} steps ({film_ff['k3_per_step']:.1f} K3 per step)")
    checks = {
        "every residual < 10 gmres_tol": res_b.max().item()
        < 10 * cfg_b.gmres_tol,
        "state finite": bool(torch.isfinite(s_b.X).all()
                             and torch.isfinite(s_b.Q).all()),
        "|q| within 1e-5 of 1": (qn_b - 1).abs().max().item() <= 1e-5,
        "bodies moved": (s_b.X - x0_b).abs().max().item() > 0,
        "K3 launched": counts_b["near_sweep"] > 0,
        "K1 not launched": counts_b["pair_sweep_sym"] == 0,
        "K2 not launched": counts_b["pair_sweep_ordered"] == 0,
        "K4 not launched": counts_b["ewald_real_sweep"] == 0,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"far-field film slice check failed: {what}")
    split_b = step_split(torch, profiling, "far-field film", lambda k: run_bd(
        geom_b, cfg_b, s_b, k, generator=gen_b,
        force_fn=lambda s_, i: force_b), SPLIT_STEPS["far-field film"])
    splits.append(split_b)
    lb = split_b["own_ms"].get("lattice_build", 0.0)
    film_ff.update(lattice_build_ms_per_step=lb,
                   lattice_build_share=lb / split_b["step_ms"])
    print(f"far-field film: lattice_build {lb:.3f} ms a step, "
          f"{100 * film_ff['lattice_build_share']:.1f}% of the step's "
          f"{split_b['step_ms']:.3f} ms (the open far-field slice above: "
          f"{FF_TIMED_STEPS / wall_f:.4f} steps/s)")
    del ctx_b

    # ---- 26. film far-field step through K3 vs the plain float32 sweep
    cfg_26, geom_26, state_26, force_26 = farfield_setup(
        torch, dev, FF_CHECK_BODIES, side=FB_CHECK_SIDE, box=FB_CHECK_BOX,
        grid=FB_CHECK_GRID)
    gen_26 = torch.Generator(device=dev).manual_seed(SEED + 9)
    draws = make_draws(geom_26, state_26, gen_26)
    s_k, aux_k = stochastic_step(geom_26, cfg_26, state_26, force_26,
                                 draws=draws)
    s_p, aux_p = stochastic_step(geom_26, cfg_26.replace(use_pallas=False),
                                 state_26, force_26, draws=draws)
    torch.cuda.synchronize()
    dX_k, dX_p = s_k.X - state_26.X, s_p.X - state_26.X
    rel26 = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    print(f"far-field film step K3 vs plain at n="
          f"{FF_CHECK_BODIES * geom_26.n_blobs}, box {FB_CHECK_BOX}, grid "
          f"{FB_CHECK_GRID}: max|dX_k - dX_p|/max|dX_p| = {rel26:.3e} (tol "
          f"{STEP_TOL:g}); iters {aux_k.iters} vs {aux_p.iters}; residual "
          f"{aux_k.residual.item():.3e} vs {aux_p.residual.item():.3e}")
    if not (rel26 <= STEP_TOL and torch.isfinite(s_k.X).all()):
        raise AssertionError(f"far-field film step through K3 disagrees with "
                             f"the plain step: {rel26}")
    film_ff["step_check_rel"] = rel26

    # ---- 27. K1's and K2's POLY forms vs the float64 plain sweep, times
    cfg_m, mgeom_m, states_m, forces_m = mixture_setup(torch, dev)
    opses_m = multi.geometry_ops_multi(mgeom_m, states_m)
    r_m = multi.concat_positions(opses_m)
    n_m = r_m.shape[0]
    rad_m = multi.blob_radii_multi(mgeom_m, opses_m, cfg_m)
    rm32 = (r_m / cfg_m.a).contiguous()
    am32 = (rad_m / cfg_m.a).contiguous()
    h_m = cfg_m.wall_h_floor
    Fm = torch.from_numpy(rng.standard_normal((2, n_m, 3))).to(dev).float()
    poly_errs = check_poly_sweeps(torch, rpy, rpy_cuda, "mixture slice", rm32,
                                  am32, Fm, h_m)
    rng_p = np.random.default_rng(SEED + 27)
    for label, r_c, a_c in poly_pair_clouds(rng_p):
        check_poly_sweeps(
            torch, rpy, rpy_cuda, label,
            torch.from_numpy(r_c).to(dev).float().contiguous(),
            torch.from_numpy(a_c).to(dev).float().contiguous(),
            torch.from_numpy(rng_p.standard_normal((2, r_c.shape[0], 3))).to(
                dev).float(), h_m)
    for k in (1, 2):
        Fk = Fm[:k].contiguous()
        for name, fn in (
                ("K1", lambda: rpy_cuda.pair_sweep_sym(rm32, Fk, True, h_m,
                                                       ahat=am32)),
                ("K2", lambda: rpy_cuda.pair_sweep_ordered(
                    rm32, 0, rm32, Fk, 0, True, h_m, ahat_rows=am32,
                    ahat_cols=am32))):
            if not torch.equal(fn(), fn()):
                raise AssertionError(f"two {name} POLY launches differ "
                                     f"bitwise, k={k}")
    print("K1 and K2 POLY launches repeat bitwise at 1 and 2 RHS")
    ids_m = torch.arange(n_m, device=dev)
    poly_t = {}
    for k in (1, 2):
        Fk = Fm[:k].contiguous()
        # fields once per unordered pair (60 + POLY_EXTRA_FLOP) and 30 per
        # RHS and direction, as the monodisperse bounds count
        b_poly = bound_ms((60 + POLY_EXTRA_FLOP + 60 * k) / 2 * n_m * n_m,
                          (12 + 4 + 24 * k) * n_m)
        b_mono = bound_ms((60 + 60 * k) / 2 * n_m * n_m, (12 + 24 * k) * n_m)
        for name in ("K1", "K2"):
            if name == "K1":
                poly_fn = lambda: rpy_cuda.pair_sweep_sym(rm32, Fk, True, h_m,
                                                          ahat=am32)
                mono_fn = lambda: rpy_cuda.pair_sweep_sym(rm32, Fk, True, h_m)
            else:
                poly_fn = lambda: rpy_cuda.pair_sweep_ordered(
                    rm32, 0, rm32, Fk, 0, True, h_m, ahat_rows=am32,
                    ahat_cols=am32)
                mono_fn = lambda: rpy_cuda.pair_sweep_ordered(
                    rm32, 0, rm32, Fk, 0, True, h_m)
            # in turns: mono, poly, poly, mono
            t = {"mono": [], "poly": []}
            for form in ("mono", "poly", "poly", "mono"):
                t[form].append(cuda_ms(
                    torch, poly_fn if form == "poly" else mono_fn, 20))
            plain = cuda_ms(torch, lambda: rpy.pair_sum(
                rm32, ids_m, rm32, ids_m, Fk, wall=True, h_floor=h_m,
                radii_rows=am32, radii_cols=am32), 2)
            poly_t[name, k] = dict(ms=min(t["poly"]), ms_mono=min(t["mono"]),
                                   turns=t, plain_ms=plain, bound=b_poly,
                                   bound_mono=b_mono,
                                   err=poly_errs[name, True, k])
            v = poly_t[name, k]
            print(f"{name} POLY form time at the mixture slice n={n_m}, wall, "
                  f"{k} RHS: {v['ms']:.4f} ms (turns mono/poly "
                  f"{t['mono']} / {t['poly']}), {v['ms'] / v['ms_mono']:.3f}x "
                  f"its monodisperse form at the same positions; plain float32"
                  f" {plain:.4f} ms; bound {b_poly[0]:.4f} ms ({b_poly[1]}), "
                  f"{v['ms'] / b_poly[0]:.2f}x (the mono form "
                  f"{v['ms_mono'] / b_mono[0]:.2f}x its {b_mono[0]:.4f} ms)")
    del Fm

    # ---- 28. the mixture slice through the POLY forms
    gen_m = torch.Generator(device=dev).manual_seed(SEED)
    x0_m = [st_.X.clone() for st_ in states_m]
    for mod in (rpy_cuda, farfield_cuda, ewald_cuda):
        mod.reset_launch_counts()
    s_m, tr_mw = multi.run_bd_multi(mgeom_m, cfg_m, states_m, MIX_WARM_STEPS,
                                    generator=gen_m,
                                    force_fn=lambda ss, i: forces_m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_m, tr_m = multi.run_bd_multi(mgeom_m, cfg_m, s_m, MIX_TIMED_STEPS,
                                   generator=gen_m,
                                   force_fn=lambda ss, i: forces_m)
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    counts_m = {**rpy_cuda.launch_counts(), **farfield_cuda.launch_counts(),
                **ewald_cuda.launch_counts()}
    steps_m = MIX_WARM_STEPS + MIX_TIMED_STEPS
    res_m = torch.cat([tr_mw["residual"], tr_m["residual"]])
    iters_m = torch.cat([tr_mw["iters"], tr_m["iters"]])
    qn_m = torch.cat([torch.linalg.norm(st_.Q, dim=1) for st_ in s_m])
    mixture = dict(n_blobs=n_m, steps_per_s=MIX_TIMED_STEPS / wall_m,
                   iters=iters_m.tolist(),
                   mean_iters=tr_m["iters"].double().mean().item(),
                   max_residual=res_m.max().item(),
                   k1_poly=counts_m["pair_sweep_sym_poly"],
                   k2_poly=counts_m["pair_sweep_ordered_poly"],
                   k1_poly_per_step=counts_m["pair_sweep_sym_poly"] / steps_m,
                   k2_poly_per_step=counts_m["pair_sweep_ordered_poly"]
                   / steps_m)
    print(f"mixture slice: {MIX_BIG} x {SHELL} + {MIX_SMALL} x "
          f"{MIX_SMALL_SHELL} scaled {MIX_SCALE} (radii {mgeom_m.radii}, a = "
          f"{cfg_m.a:.6f}) = {n_m} blobs: {MIX_TIMED_STEPS} steps in "
          f"{wall_m:.3f} s = {mixture['steps_per_s']:.4f} steps/s; GMRES "
          f"iters per step {iters_m.tolist()}; max residual "
          f"{res_m.max().item():.3e}; max||q|-1| "
          f"{(qn_m - 1).abs().max().item():.3e}; launches {counts_m} over "
          f"{steps_m} steps")
    checks = {
        "every residual < 10 gmres_tol": res_m.max().item()
        < 10 * cfg_m.gmres_tol,
        "state finite": all(bool(torch.isfinite(st_.X).all()
                                 and torch.isfinite(st_.Q).all())
                            for st_ in s_m),
        "|q| within 1e-5 of 1": (qn_m - 1).abs().max().item() <= 1e-5,
        "bodies moved": all((st_.X - x0).abs().max().item() > 0
                            for st_, x0 in zip(s_m, x0_m)),
        "K1 POLY launched": counts_m["pair_sweep_sym_poly"] > 0,
        "K2 POLY launched": counts_m["pair_sweep_ordered_poly"] > 0,
        "K1/K2 monodisperse forms not launched":
            counts_m["pair_sweep_sym"] == counts_m["pair_sweep_ordered"] == 0,
        "K3/K4 not launched": counts_m["near_sweep"]
        == counts_m["ewald_real_sweep"] == 0,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"mixture slice check failed: {what}")
    split_m = step_split(torch, profiling, "mixture", lambda k: (
        multi.run_bd_multi(mgeom_m, cfg_m, s_m, k, generator=gen_m,
                           force_fn=lambda ss, i: forces_m)),
        MIX_SPLIT_STEPS)
    splits.append(split_m)

    # ---- 29. mixture step through the kernels vs the plain float32 sweep
    draws_m = multi.make_draws_multi(mgeom_m, s_m, gen_m)
    sk, aux_mk = multi.stochastic_step_multi(mgeom_m, cfg_m, s_m, forces_m,
                                             draws=draws_m)
    sp, aux_mp = multi.stochastic_step_multi(
        mgeom_m, cfg_m.replace(use_pallas=False), s_m, forces_m,
        draws=draws_m)
    torch.cuda.synchronize()
    dX_k = torch.cat([a_.X - b_.X for a_, b_ in zip(sk, s_m)])
    dX_p = torch.cat([a_.X - b_.X for a_, b_ in zip(sp, s_m)])
    rel29 = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
    print(f"mixture step kernels vs plain: max|dX_k - dX_p|/max|dX_p| = "
          f"{rel29:.3e} (tol {STEP_TOL:g}); iters {aux_mk.iters} vs "
          f"{aux_mp.iters}; residual {aux_mk.residual.item():.3e} vs "
          f"{aux_mp.residual.item():.3e}")
    if not (rel29 <= STEP_TOL and torch.isfinite(dX_k).all()):
        raise AssertionError(f"the mixture step through the kernels "
                             f"disagrees with the plain step: {rel29}")
    mixture["step_check_rel"] = rel29

    # ---- 30. the monodisperse mixture and the dense slice, same run
    cfg_u, mgeom_u, states_u, forces_u = mixture_setup(torch, dev,
                                                       poly=False)
    gen_u = torch.Generator(device=dev).manual_seed(SEED)
    rates = {}
    for label in ("mono mixture", "dense", "poly mixture"):
        if label == "dense":
            def run(k, st0):
                return run_bd(geom, cfg, st0, k, generator=gen,
                              force_fn=lambda s_, i: force)
            st0 = state
        else:
            mg_, cf_, fo_ = ((mgeom_u, cfg_u, forces_u)
                             if label == "mono mixture"
                             else (mgeom_m, cfg_m, forces_m))

            def run(k, st0, mg_=mg_, cf_=cf_, fo_=fo_):
                return multi.run_bd_multi(mg_, cf_, st0, k, generator=gen_u,
                                          force_fn=lambda ss, i: fo_)
            st0 = states_u if label == "mono mixture" else states_m
        st1, tr_w = run(MIX_WARM_STEPS, st0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st1, tr_t = run(MIX_TIMED_STEPS, st1)
        torch.cuda.synchronize()
        rates[label] = dict(
            steps_per_s=MIX_TIMED_STEPS / (time.perf_counter() - t0),
            mean_iters=tr_t["iters"].double().mean().item(),
            max_residual=torch.cat([tr_w["residual"],
                                    tr_t["residual"]]).max().item())
        if not rates[label]["max_residual"] < 10 * cfg_m.gmres_tol:
            raise AssertionError(f"{label}: a residual above 10·gmres_tol")
    mixture["same_run"] = rates
    mixture["ratio_mono_mixture_to_dense"] = (
        rates["mono mixture"]["steps_per_s"] / rates["dense"]["steps_per_s"])
    mixture["ratio_poly_mixture_to_dense"] = (
        rates["poly mixture"]["steps_per_s"] / rates["dense"]["steps_per_s"])
    print("same run, steps/s (mean GMRES iters): " + ", ".join(
        f"{k} {v['steps_per_s']:.4f} ({v['mean_iters']:.2f})"
        for k, v in rates.items())
        + f"; mono mixture / dense "
        f"{mixture['ratio_mono_mixture_to_dense']:.3f}, poly mixture / "
        f"dense {mixture['ratio_poly_mixture_to_dense']:.3f}")

    # ---- 31. mixture RAS on the card: tests/test_multi.py's wall mixture
    import rigid_body_light_tpu_torch as rt
    _, ref12 = rt.load_structure("shell_N_12")
    _, ref42 = rt.load_structure("shell_N_42")
    mgeom_r = multi.MultiGeometry.create([ref12, ref42], dtype=torch.float32,
                                         device=dev)
    X12 = np.array([[0, 0, 1.2], [1.4, 0, 1.2], [0, 1.4, 1.1],
                    [1.4, 1.4, 1.25], [0.7, 0.7, 2.3], [2.1, 0.7, 1.3]])
    X42 = np.array([[0.7, -1.3, 1.4], [-1.3, 0.7, 1.45], [2.8, 2.2, 1.5]])
    states_r = tuple(rt.make_state(x, np.tile([1.0, 0, 0, 0], (len(x), 1)),
                                   dtype=torch.float32, device=dev)
                     for x in (X12, X42))
    rng_r = np.random.default_rng(7)
    F_r = tuple(torch.from_numpy(rng_r.standard_normal((b, 6))).float().to(
        dev) for b in (6, 3))
    solve_r = {}
    for mode in ("block_free", "ras"):
        cfg_r = rt.SimulationConfig(a=0.24, wall=True, dtype=torch.float32,
                                    gmres_tol=MIX_RAS_TOL, gmres_maxiter=300,
                                    pc_mode=mode)
        solve_r[mode] = multi.solve_saddle_multi(mgeom_r, cfg_r, states_r,
                                                 None, F_r)
    rb, rr = solve_r["block_free"], solve_r["ras"]
    U_b, U_r = torch.cat(rb.Us), torch.cat(rr.Us)
    du_r = ((U_r - U_b).abs().max() / U_b.abs().max()).item()
    print(f"mixture RAS (6 x shell_N_12 + 3 x shell_N_42 at the wall, "
          f"float32, gmres_tol {MIX_RAS_TOL:g}): block_free {rb.iters} "
          f"iterations (residual {rb.residual.item():.3e}), RAS {rr.iters} "
          f"(residual {rr.residual.item():.3e}); max|U_ras - U_bf|/max|U_bf|"
          f" = {du_r:.3e} (tol {10 * MIX_RAS_TOL:g})")
    if not (rr.iters < rb.iters and du_r <= 10 * MIX_RAS_TOL
            and rr.residual.item() < 10 * MIX_RAS_TOL
            and rb.residual.item() < 10 * MIX_RAS_TOL):
        raise AssertionError("mixture RAS: it must take fewer iterations "
                             "than block_free and agree with it")
    mixture["ras"] = dict(iters_block_free=rb.iters, iters_ras=rr.iters,
                          u_rel=du_r)

    # ---- 32. K3's POLY form vs the float64 plain near sweep, its times
    cfg_x, mgeom_x, states_x, forces_x = farfield_mixture_setup(
        torch, dev, FF_BODIES)
    opses_x = multi.geometry_ops_multi(mgeom_x, states_x)
    r_x = multi.concat_positions(opses_x)
    n_x = r_x.shape[0]
    rad_x = multi.blob_radii_multi(mgeom_x, opses_x, cfg_x)
    a_x = cfg_x.a
    fx_kw = dict(a=a_x, eta=cfg_x.eta, wall=True, grid=FF_GRID, p=FF_P,
                 radii=rad_x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_x = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    geo_x = farfield.prepare_geometry(r_x, **fx_kw)
    torch.cuda.synchronize()
    geo_x_ms = (time.perf_counter() - t0) * 1e3
    geo_x_peak = torch.cuda.max_memory_allocated() - base_x
    lat_x = sum(t_.numel() * t_.element_size()
                for t_ in (geo_x.khat_free, geo_x.khat_wall))
    ctx_x = farfield.prepare(r_x, geo=geo_x, **fx_kw)
    rng_x = np.random.default_rng(SEED + 32)
    k3p_err = check_near_forms(torch, farfield, farfield_cuda,
                              "far-field mixture slice", ctx_x, rng_x)
    for label, r_c, a_c in poly_pair_clouds(rng_x):
        grid_c = (6, 6, 2) if label == "ragged" else (3, 3, 1)
        ctx_c = farfield.prepare(torch.from_numpy(r_c).to(dev).float(),
                                 wall=True, grid=grid_c, p=FF_P,
                                 radii=torch.from_numpy(a_c).to(dev).float())
        check_near_forms(torch, farfield, farfield_cuda, label, ctx_c, rng_x)
    cfg_xb, mgeom_xb, states_xb, forces_xb = farfield_mixture_setup(
        torch, dev, FF_CHECK_BODIES, side=FB_CHECK_SIDE, box=FB_CHECK_BOX,
        grid=FB_CHECK_GRID)
    opses_xb = multi.geometry_ops_multi(mgeom_xb, states_xb)
    r_xb = multi.concat_positions(opses_xb)
    rad_xb = multi.blob_radii_multi(mgeom_xb, opses_xb, cfg_xb)
    xb_kw = dict(a=a_x, eta=cfg_xb.eta, wall=True, grid=FB_CHECK_GRID,
                 p=FF_P, box=FB_CHECK_BOX, image_shells=FB_SHELLS,
                 radii=rad_xb)
    ctx_xb = farfield.prepare(r_xb, **xb_kw)
    box_xb = tuple(float(np.float32(b / a_x)) for b in FB_CHECK_BOX)
    k3pb_err = check_near_forms(torch, farfield, farfield_cuda,
                               "far-field mixture film check set", ctx_xb,
                               rng_x, walls=(True,), box=box_xb,
                               wrap=FB_CHECK_GRID[:2])
    r_s, box_s, grid_s = film_near_clouds()["self"]
    ctx_s = farfield.prepare(
        torch.from_numpy(r_s).to(dev), wall=True, grid=grid_s, p=3,
        box=box_s, image_shells=1, radii=torch.from_numpy(
            rng_x.choice([0.6, 1.1], r_s.shape[0])).to(dev).float())
    check_near_forms(torch, farfield, farfield_cuda, "self (a tile meeting "
                    "itself across the seam)", ctx_s, rng_x, walls=(True,),
                    box=tuple(float(np.float32(b)) for b in box_s),
                    wrap=grid_s[:2])
    k3p = k3_poly_times(torch, farfield, farfield_cuda,
                        "the far-field mixture slice", ctx_x, rng_x)
    k3pb = k3_poly_times(torch, farfield, farfield_cuda,
                         "the far-field mixture film check set", ctx_xb,
                         rng_x, box=box_xb, wrap=FB_CHECK_GRID[:2])
    del ctx_c, ctx_s

    # ---- 33. the polydisperse far field vs the exact POLY operator (K1)
    F33 = torch.from_numpy(rng_x.standard_normal((n_x, 3))).to(dev).float()
    U_fx = farfield.mobility_apply(F33, r_x, ctx=ctx_x, **fx_kw)
    U_ex = rpy_cuda.mobility_apply(F33, r_x, a=a_x, eta=cfg_x.eta, wall=True,
                                   radii=rad_x)
    torch.cuda.synchronize()
    fx_rel = ((U_fx - U_ex).abs().max() / U_ex.abs().max()).item()
    fx_same = torch.equal(U_fx, farfield.mobility_apply(F33, r_x, ctx=ctx_x,
                                                        **fx_kw))
    fx_ms = cuda_ms(torch, lambda: farfield.mobility_apply(
        F33, r_x, ctx=ctx_x, **fx_kw), 3)
    ex_x_ms = cuda_ms(torch, lambda: rpy_cuda.mobility_apply(
        F33, r_x, a=a_x, eta=cfg_x.eta, wall=True, radii=rad_x), 2)
    prep_x_ms = cuda_ms(torch, lambda: farfield.prepare(
        r_x, geo=geo_x, **fx_kw), 3)
    print(f"polydisperse far field vs the exact POLY operator (K1) at "
          f"n={n_x}, wall, grid {FF_GRID}, p={FF_P}: max|dU|/max|U| = "
          f"{fx_rel:.3e} (tol {FF_OPERATOR_TOL:g}); two products bitwise "
          f"equal: {fx_same}; apply {fx_ms:.3f} ms with the setup hoisted, "
          f"the exact K1 POLY apply {ex_x_ms:.3f} ms; lattice build "
          f"(prepare_geometry, 2 free + 3 wall lattices, "
          f"{lat_x / 1e9:.3f} GB) {geo_x_ms:.3f} ms, its peak memory "
          f"{geo_x_peak / 1e9:.3f} GB above what was held; position setup "
          f"(prepare with geo) {prep_x_ms:.3f} ms")
    if not (fx_rel <= FF_OPERATOR_TOL and torch.isfinite(U_fx).all()
            and fx_same):
        raise AssertionError(f"the polydisperse far field disagrees with the "
                             f"exact operator ({fx_rel}) or with itself "
                             f"({fx_same})")
    del U_fx, U_ex, ctx_x, geo_x

    # ---- 34. the far-field mixture slice through K3's POLY form
    gen_x = torch.Generator(device=dev).manual_seed(SEED)
    x0_x = [st_.X.clone() for st_ in states_x]
    for mod in (rpy_cuda, farfield_cuda, ewald_cuda):
        mod.reset_launch_counts()
    s_x, tr_xw = multi.run_bd_multi(mgeom_x, cfg_x, states_x, FF_WARM_STEPS,
                                    generator=gen_x,
                                    force_fn=lambda ss, i: forces_x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_x, tr_x = multi.run_bd_multi(mgeom_x, cfg_x, s_x, FF_TIMED_STEPS,
                                   generator=gen_x,
                                   force_fn=lambda ss, i: forces_x)
    torch.cuda.synchronize()
    wall_x = time.perf_counter() - t0
    counts_x = {**rpy_cuda.launch_counts(), **farfield_cuda.launch_counts(),
                **ewald_cuda.launch_counts()}
    steps_x = FF_WARM_STEPS + FF_TIMED_STEPS
    res_x = torch.cat([tr_xw["residual"], tr_x["residual"]])
    iters_x = torch.cat([tr_xw["iters"], tr_x["iters"]])
    qn_x = torch.cat([torch.linalg.norm(st_.Q, dim=1) for st_ in s_x])
    ff_mix = dict(n_blobs=n_x, steps_per_s=FF_TIMED_STEPS / wall_x,
                  mono_farfield_steps_per_s=FF_TIMED_STEPS / wall_f,
                  iters=iters_x.tolist(), max_residual=res_x.max().item(),
                  k3_poly=counts_x["near_sweep_poly"],
                  k3_poly_per_step=counts_x["near_sweep_poly"] / steps_x,
                  operator_rel=fx_rel, apply_ms=fx_ms,
                  exact_apply_ms=ex_x_ms, lattice_build_ms=geo_x_ms,
                  lattice_build_peak_bytes=geo_x_peak, lattice_bytes=lat_x,
                  position_setup_ms=prep_x_ms)
    print(f"far-field mixture slice: {FF_BODIES} x {FF_SHELL} + {FF_BODIES} "
          f"x {MIX_SMALL_SHELL} scaled {MIX_SCALE} (radii {mgeom_x.radii}, "
          f"a = {a_x:.6f}) = {n_x} blobs, grid {FF_GRID}, p={FF_P}: "
          f"{FF_TIMED_STEPS} steps in {wall_x:.3f} s = "
          f"{ff_mix['steps_per_s']:.4f} steps/s (the monodisperse far-field "
          f"slice, phase 8 of this run: {ff_mix['mono_farfield_steps_per_s']:.4f}"
          f"); GMRES iters per step {iters_x.tolist()}; max residual "
          f"{res_x.max().item():.3e}; max||q|-1| "
          f"{(qn_x - 1).abs().max().item():.3e}; launches {counts_x} over "
          f"{steps_x} steps ({ff_mix['k3_poly_per_step']:.1f} K3 POLY per "
          f"step)")
    checks = {
        "every residual < 10 gmres_tol": res_x.max().item()
        < 10 * cfg_x.gmres_tol,
        "state finite": all(bool(torch.isfinite(st_.X).all()
                                 and torch.isfinite(st_.Q).all())
                            for st_ in s_x),
        "|q| within 1e-5 of 1": (qn_x - 1).abs().max().item() <= 1e-5,
        "bodies moved": all((st_.X - x0).abs().max().item() > 0
                            for st_, x0 in zip(s_x, x0_x)),
        "K3 POLY launched": counts_x["near_sweep_poly"] > 0,
        "mono K3 not launched": counts_x["near_sweep"] == 0,
        "K1/K2 not launched (mono or POLY)": sum(
            counts_x[k_] for k_ in ("pair_sweep_sym", "pair_sweep_ordered",
                                    "pair_sweep_sym_poly",
                                    "pair_sweep_ordered_poly")) == 0,
        "K4 not launched": counts_x["ewald_real_sweep"] == 0,
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"far-field mixture slice check failed: "
                                 f"{what}")
    split_x = step_split(torch, profiling, "far-field mixture", lambda k: (
        multi.run_bd_multi(mgeom_x, cfg_x, s_x, k, generator=gen_x,
                           force_fn=lambda ss, i: forces_x)), FM_SPLIT_STEPS)
    splits.append(split_x)

    # ---- 35. far-field mixture steps through K3 vs the plain float32 sweep
    cfg_xc, mgeom_xc, states_xc, forces_xc = farfield_mixture_setup(
        torch, dev, FF_CHECK_BODIES)
    counters = (rpy_cuda, farfield_cuda, ewald_cuda)
    ff_mix["step_check_rel"], _ = mixture_step_check(
        torch, multi, "(open)", cfg_xc, mgeom_xc, states_xc, forces_xc,
        torch.Generator(device=dev).manual_seed(SEED + 35), counters)
    ff_mix["film_step_check_rel"], counts_xb = mixture_step_check(
        torch, multi, f"(film, image_shells {FB_SHELLS})", cfg_xb, mgeom_xb,
        states_xb, forces_xb,
        torch.Generator(device=dev).manual_seed(SEED + 36), counters)
    ff_mix["k3_poly_box_film_step"] = counts_xb["near_sweep_poly"]
    if not (counts_xb["near_sweep_poly"] > 0
            and counts_xb["near_sweep"] == 0):
        raise AssertionError(f"the film mixture step did not go through K3's "
                             f"POLY x BOX form: {counts_xb}")

    # ---- 36. K1's and K2's POLY x BOX forms vs the float64 plain sweep
    box_pf = tuple(float(np.float32(b / cfg_m.a)) for b in PF_BOX)
    rng_pf = np.random.default_rng(SEED + 36)
    F_pf = torch.from_numpy(rng_pf.standard_normal((2, n_m, 3))).to(
        dev).float()
    pf_errs = check_poly_box_sweeps(torch, rpy, rpy_cuda,
                                    "polydisperse film", rm32, am32, F_pf,
                                    box_pf, h_m)
    for label, r_c, a_c in poly_pair_clouds(rng_pf):
        # a box the cloud overfills, so its pairs cross both seams
        L_c = float(np.float32(0.8 * (r_c[:, 0].max() - r_c[:, 0].min())))
        check_poly_box_sweeps(
            torch, rpy, rpy_cuda, label,
            torch.from_numpy(r_c).to(dev).float().contiguous(),
            torch.from_numpy(a_c).to(dev).float().contiguous(),
            torch.from_numpy(rng_pf.standard_normal(
                (2, r_c.shape[0], 3))).to(dev).float(), (L_c, L_c), h_m)
    pf_t = {"K1": {}, "K2": {}}
    # K1 at 1 RHS (the GMRES and RFD products), K2 at 2 (the fused noise)
    for name, k in (("K1", 1), ("K2", 2)):
        Fk = F_pf[:k].contiguous()
        for S in (0, PF_SHELLS):
            args = rpy_cuda.box_args(box_pf, S)
            if name == "K1":
                forms = {
                    "poly_box": lambda: rpy_cuda.pair_sweep_sym(
                        rm32, Fk, True, h_m, box=args, ahat=am32),
                    "box": lambda: rpy_cuda.pair_sweep_sym(
                        rm32, Fk, True, h_m, box=args),
                    "poly": lambda: rpy_cuda.pair_sweep_sym(
                        rm32, Fk, True, h_m, ahat=am32)}
            else:
                forms = {
                    "poly_box": lambda: rpy_cuda.pair_sweep_ordered(
                        rm32, 0, rm32, Fk, 0, True, h_m, box=args,
                        ahat_rows=am32, ahat_cols=am32),
                    "box": lambda: rpy_cuda.pair_sweep_ordered(
                        rm32, 0, rm32, Fk, 0, True, h_m, box=args),
                    "poly": lambda: rpy_cuda.pair_sweep_ordered(
                        rm32, 0, rm32, Fk, 0, True, h_m, ahat_rows=am32,
                        ahat_cols=am32)}
            # in turns: box, poly, poly x box, poly x box, poly, box
            t = {f: [] for f in forms}
            for form in ("box", "poly", "poly_box", "poly_box", "poly",
                         "box"):
                t[form].append(cuda_ms(torch, forms[form],
                                       20 if S == 0 else 5))
            plain = cuda_ms(torch, lambda: rpy.pair_sum(
                rm32, ids_m, rm32, ids_m, Fk, wall=True, h_floor=h_m,
                box=box_pf, image_shells=S, radii_rows=am32,
                radii_cols=am32), 1)
            n_img = (2 * S + 1) ** 2
            flops = n_img * (60 + POLY_EXTRA_FLOP + 60 * k) / 2 * n_m * n_m
            b = bound_ms(flops, (12 + 4 + 24 * k) * n_m)
            v = dict(k=k, ms=min(t["poly_box"]), ms_box=min(t["box"]),
                     ms_poly=min(t["poly"]), turns=t, plain_ms=plain,
                     bound=b)
            pf_t[name][S] = v
            print(f"{name} POLY x BOX form at the polydisperse film n={n_m}, "
                  f"box {PF_BOX}, image_shells={S} ({n_img} offsets), {k} "
                  f"RHS: {v['ms']:.4f} ms ({flops / (v['ms'] * 1e-3) / 1e9:.1f}"
                  f" GFLOP/s), {v['ms'] / v['ms_box']:.3f}x its box form "
                  f"({v['ms_box']:.4f} ms) and {v['ms'] / v['ms_poly']:.3f}x "
                  f"its POLY form ({v['ms_poly']:.4f} ms) at the same "
                  f"positions, turns {t}; plain float32 {plain:.4f} ms; bound "
                  f"{b[0]:.4f} ms ({b[1]}), {v['ms'] / b[0]:.2f}x the bound")
    del F_pf

    # ---- 37. the polydisperse film through the driver (run.main)
    from rigid_body_light_tpu_torch import run as run_mod
    from rigid_body_light_tpu_torch.runtime import read_trajectory
    from rigid_body_light_tpu_torch.utils import checkpoint as ckpt_mod

    pf_dir = tempfile.mkdtemp(prefix="chip_smoke_film_")
    pf_path, pf_conf = poly_film_config(pf_dir, 2 * PF_CHUNK, PF_CHUNK,
                                        PF_SAVE_EVERY)
    for mod in (rpy_cuda, farfield_cuda, ewald_cuda):
        mod.reset_launch_counts()
    pf_lines = run_driver(run_mod, [pf_path])
    counts_pf = {**rpy_cuda.launch_counts(), **farfield_cuda.launch_counts(),
                 **ewald_cuda.launch_counts()}
    pf_out = pf_conf["output_dir"]
    steps_pf, _, X_pf, Q_pf = read_trajectory(
        os.path.join(pf_out, "trajectory.rblt"))
    pf_res = max(ln["max_residual"] for ln in pf_lines[:-1])
    qn_pf = np.linalg.norm(Q_pf.astype(np.float64), axis=-1)
    poly_film = dict(
        n_blobs=n_m, steps_per_s=pf_lines[1]["steps_per_sec"],
        warmup_steps_per_s=pf_lines[0]["steps_per_sec"],
        mean_gmres_iters=[ln["mean_gmres_iters"] for ln in pf_lines[:-1]],
        max_residual=pf_res,
        k1_poly_box=counts_pf["pair_sweep_sym_poly_box"],
        k2_poly_box=counts_pf["pair_sweep_ordered_poly_box"],
        k1_poly_box_per_step=counts_pf["pair_sweep_sym_poly_box"]
        / (2 * PF_CHUNK),
        k2_poly_box_per_step=counts_pf["pair_sweep_ordered_poly_box"]
        / (2 * PF_CHUNK))
    print(f"polydisperse film through the driver: {MIX_BIG} x {SHELL} + "
          f"{MIX_SMALL} x {MIX_SMALL_SHELL} scaled {MIX_SCALE} = {n_m} blobs "
          f"in the {PF_BOX} box, image_shells {PF_SHELLS}: the timed chunk "
          f"of {PF_CHUNK} steps at {poly_film['steps_per_s']} steps/s (the "
          f"warm-up chunk {poly_film['warmup_steps_per_s']}); max residual "
          f"{pf_res:.3e}; frames {steps_pf.tolist()}; max||q|-1| "
          f"{np.abs(qn_pf - 1).max():.3e}; launches {counts_pf} over "
          f"{2 * PF_CHUNK} steps")
    no_other = [k_ for k_ in ("pair_sweep_sym", "pair_sweep_ordered",
                              "pair_sweep_sym_poly",
                              "pair_sweep_ordered_poly", "near_sweep",
                              "near_sweep_poly", "ewald_real_sweep")
                if counts_pf.get(k_, 0)]
    want_frames = list(range(PF_SAVE_EVERY, 2 * PF_CHUNK + 1, PF_SAVE_EVERY))
    checks = {
        "every residual < 10 gmres_tol": pf_res < 10 * 1e-4,
        "frames read back": steps_pf.tolist() == want_frames,
        "state finite": bool(np.isfinite(X_pf).all()
                             and np.isfinite(Q_pf).all()),
        "|q| within 1e-5 of 1": np.abs(qn_pf - 1).max() <= 1e-5,
        "bodies moved": np.abs(X_pf[-1] - X_pf[0]).max() > 0,
        "K1 POLY x BOX launched": counts_pf["pair_sweep_sym_poly_box"] > 0,
        "K2 POLY x BOX launched": counts_pf["pair_sweep_ordered_poly_box"]
        > 0,
        f"no other kernel launched ({no_other})": not no_other,
        "a done line": pf_lines[-1].get("done") is True
        and pf_lines[-1]["frames"] == len(want_frames),
    }
    for what, ok in checks.items():
        if not ok:
            raise AssertionError(f"polydisperse film driver check failed: "
                                 f"{what}")
    # resume from the chunk's checkpoint: one more chunk, appended
    pf_ckpt = os.path.join(pf_out, "checkpoint.npz")
    states_37, _, _, _ = ckpt_mod.load_checkpoint(pf_ckpt, device=dev)
    pf_path2, _ = poly_film_config(pf_dir, PF_CHUNK, PF_CHUNK, PF_SAVE_EVERY)
    pf_lines2 = run_driver(run_mod, [pf_path2, "--resume", pf_ckpt])
    steps_pf2, _, X_pf2, _ = read_trajectory(
        os.path.join(pf_out, "trajectory.rblt"))
    want2 = list(range(PF_SAVE_EVERY, 3 * PF_CHUNK + 1, PF_SAVE_EVERY))
    poly_film["resume_steps_per_s"] = pf_lines2[0]["steps_per_sec"]
    poly_film["resume_max_residual"] = pf_lines2[0]["max_residual"]
    print(f"polydisperse film resumed at step {2 * PF_CHUNK}: frames "
          f"{steps_pf2.tolist()}")
    if not (steps_pf2.tolist() == want2
            and np.array_equal(X_pf2[:len(want_frames)], X_pf)
            and pf_lines2[0]["max_residual"] < 10 * 1e-4):
        raise AssertionError(f"the resumed film run left a gap or changed "
                             f"earlier frames: {steps_pf2.tolist()}")

    # ---- 38. a polydisperse film step through the kernels vs the plain
    # float32 sweep (at the driver's state after phase 37, off the lattice
    # whose pairs lie on the seams); the far-field mixture's film operator
    # vs the exact polydisperse image operator (K1's POLY x BOX form)
    cfg_pf = cfg_m.replace(box=PF_BOX, image_shells=PF_SHELLS)
    poly_film["step_check_rel"], counts_38 = mixture_step_check(
        torch, multi, f"(polydisperse film, image_shells {PF_SHELLS})",
        cfg_pf, mgeom_m, states_37, forces_m,
        torch.Generator(device=dev).manual_seed(SEED + 38),
        (rpy_cuda, farfield_cuda, ewald_cuda))
    if not (counts_38["pair_sweep_sym_poly_box"] > 0
            and counts_38["pair_sweep_ordered_poly_box"] > 0):
        raise AssertionError(f"the polydisperse film step did not go "
                             f"through the POLY x BOX forms: {counts_38}")
    gen_38 = torch.Generator(device=dev).manual_seed(SEED + 38)
    splits.append(step_split(
        torch, profiling, f"polydisperse film (image_shells {PF_SHELLS})",
        lambda k: multi.run_bd_multi(mgeom_m, cfg_pf, states_37, k,
                                     generator=gen_38,
                                     force_fn=lambda ss, i: forces_m),
        MIX_SPLIT_STEPS))
    F38 = torch.from_numpy(rng_x.standard_normal(
        (r_xb.shape[0], 3))).to(dev).float()
    U_fxb = farfield.mobility_apply(F38, r_xb, ctx=ctx_xb, **xb_kw)
    rpy_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    U_exb = rpy_cuda.mobility_apply(F38, r_xb, a=a_x, eta=cfg_xb.eta,
                                    wall=True, box=FB_CHECK_BOX,
                                    image_shells=FB_SHELLS, radii=rad_xb)
    torch.cuda.synchronize()
    ex_xb_ms = (time.perf_counter() - t0) * 1e3
    k1_38 = rpy_cuda.launch_counts()["pair_sweep_sym_poly_box"]
    fxb_rel = ((U_fxb - U_exb).abs().max() / U_exb.abs().max()).item()
    print(f"far-field mixture film operator vs the exact polydisperse image "
          f"operator (K1's POLY x BOX form at image_shells {FB_SHELLS}, the "
          f"self images at each blob's radius; {k1_38} launch, "
          f"{ex_xb_ms:.1f} ms) at n={r_xb.shape[0]}, box {FB_CHECK_BOX}: "
          f"max|dU|/max|U| = {fxb_rel:.3e} (tol {FF_OPERATOR_TOL:g})")
    if not (fxb_rel <= FF_OPERATOR_TOL and k1_38 == 1
            and torch.isfinite(U_fxb).all()):
        raise AssertionError(f"the far-field mixture film disagrees with the "
                             f"exact polydisperse image operator: {fxb_rel}")
    ff_mix["film_operator_rel"] = fxb_rel
    del U_fxb, U_exb, ctx_xb

    # ---- 39. drift_mode="em_exact" and the unpreconditioned fused noise,
    # on the dense slice (run_bd) and the mixture (run_bd_multi); the driver
    # on the repo's example configs
    modes = {"em_exact": dict(drift_mode="em_exact"),
             "unpreconditioned": dict(lanczos_precond=False)}
    stepper_modes = {}
    counters = (rpy_cuda, farfield_cuda, ewald_cuda)
    for mode, kw in modes.items():
        for sl in ("dense", "mixture"):
            gen_39 = torch.Generator(device=dev).manual_seed(SEED + 39)
            if sl == "dense":
                cfg_39 = cfg.replace(**kw)
                draws_39 = make_draws(geom, s, gen_39, cfg_39)
                s_k, aux_k = stochastic_step(geom, cfg_39, s, force,
                                             draws=draws_39)
                s_p, aux_p = stochastic_step(
                    geom, cfg_39.replace(use_pallas=False), s, force,
                    draws=draws_39)
                torch.cuda.synchronize()
                dX_k, dX_p = s_k.X - s.X, s_p.X - s.X
                run = lambda k_, g_: run_bd(  # noqa: E731
                    geom, cfg_39, s, k_, generator=g_,
                    force_fn=lambda s_, i: force)
            else:
                cfg_39 = cfg_m.replace(**kw)
                draws_39 = multi.make_draws_multi(mgeom_m, s_m, gen_39,
                                                  cfg_39)
                sk_, aux_k = multi.stochastic_step_multi(
                    mgeom_m, cfg_39, s_m, forces_m, draws=draws_39)
                sp_, aux_p = multi.stochastic_step_multi(
                    mgeom_m, cfg_39.replace(use_pallas=False), s_m, forces_m,
                    draws=draws_39)
                torch.cuda.synchronize()
                dX_k = torch.cat([a_.X - b_.X for a_, b_ in zip(sk_, s_m)])
                dX_p = torch.cat([a_.X - b_.X for a_, b_ in zip(sp_, s_m)])
                run = lambda k_, g_: multi.run_bd_multi(  # noqa: E731
                    mgeom_m, cfg_39, s_m, k_, generator=g_,
                    force_fn=lambda ss, i: forces_m)
            rel = ((dX_k - dX_p).abs().max() / dX_p.abs().max()).item()
            reset_launches(counters)
            run(1, gen_39)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, tr_39 = run(MODE_TIMED_STEPS, gen_39)
            torch.cuda.synchronize()
            sps = MODE_TIMED_STEPS / (time.perf_counter() - t0)
            cnt = launches(counters)
            stepper_modes[f"{mode} {sl}"] = dict(
                step_check_rel=rel, steps_per_s=sps,
                iters=tr_39["iters"].tolist(),
                max_residual=tr_39["residual"].max().item(), launches=cnt)
            print(f"{mode} on the {sl} slice: step through the kernels vs "
                  f"the plain float32 sweep max|dX_k - dX_p|/max|dX_p| = "
                  f"{rel:.3e} (tol {STEP_TOL:g}), iters {aux_k.iters} vs "
                  f"{aux_p.iters}; 1 + {MODE_TIMED_STEPS} steps at "
                  f"{sps:.4f} steps/s, iters {tr_39['iters'].tolist()}, max "
                  f"residual {tr_39['residual'].max().item():.3e}; launches "
                  f"{cnt}")
            if not (rel <= STEP_TOL and torch.isfinite(dX_k).all()
                    and tr_39["residual"].max().item() < 10 * cfg_39.gmres_tol
                    and cnt):
                raise AssertionError(f"{mode} on the {sl} slice failed: "
                                     f"step {rel}, launches {cnt}")
    examples = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    for ex in EXAMPLES:
        with open(os.path.join(repo, "examples", ex)) as f:
            conf_ex = json.load(f)
        conf_ex["output_dir"] = os.path.join(pf_dir, ex[:-5])
        conf_ex["n_steps"] = conf_ex["checkpoint_every"]
        ex_path = os.path.join(pf_dir, ex)
        with open(ex_path, "w") as f:
            json.dump(conf_ex, f)
        rpy_cuda.reset_launch_counts()
        ex_lines = run_driver(run_mod, [ex_path])
        ex_steps = read_trajectory(os.path.join(conf_ex["output_dir"],
                                                "trajectory.rblt"))[0]
        cnt = {k_: v_ for k_, v_ in rpy_cuda.launch_counts().items() if v_}
        examples[ex] = dict(steps=conf_ex["n_steps"],
                            steps_per_s=ex_lines[0]["steps_per_sec"],
                            max_residual=ex_lines[0]["max_residual"],
                            launches=cnt)
        print(f"the driver on examples/{ex}, {conf_ex['n_steps']} steps: "
              f"{ex_lines[0]}; frames {len(ex_steps)}; launches {cnt}")
        # every step committed: its residual below the configuration's
        # max_step_residual (the examples' minimum-image film is
        # indefinite and its GMRES can stop above gmres_tol at maxiter)
        if not (ex_lines[0]["max_residual"] < EXAMPLE_MAX_RESIDUAL
                and len(ex_steps) == conf_ex["n_steps"]
                // conf_ex["save_every"]
                and cnt.get("pair_sweep_sym", 0) > 0):
            raise AssertionError(f"the driver on examples/{ex} failed")
    shutil.rmtree(pf_dir)

    # ---- 40. the RigidBody API (numpy in and out) at the dense slice
    torch.cuda.empty_cache()
    rigid = rigid_body_dense(torch, dev, cfg, force, counters)

    # ---- 41. the RigidBody API at the far-field slice
    torch.cuda.empty_cache()
    rigid_ff = rigid_body_farfield(torch, dev, counters)
    print(json.dumps({"rigid_body": rigid, "rigid_body_farfield": rigid_ff}))

    # ---- 42-45. the balanced split: the tile sweep, the gridded wave part,
    # polydisperse Ewald
    t_bal = time.perf_counter()
    balanced = balanced_split_phases(torch, dev, counters)
    balanced["seconds"] = time.perf_counter() - t_bal
    print(json.dumps({"balanced_split": balanced}))

    # ---- 46-48. the far field's band tier
    torch.cuda.empty_cache()
    t_band = time.perf_counter()
    band = band_phases(torch, dev, counters)
    band["seconds"] = time.perf_counter() - t_band
    print(json.dumps({"band_tier": band}))

    # ---- 49. the adjoints
    torch.cuda.empty_cache()
    t_adj = time.perf_counter()
    adj = adjoint_phases(torch, dev, counters)
    adj["seconds"] = time.perf_counter() - t_adj
    print(json.dumps({"adjoints": adj}))

    # ---- 50-54. distribution
    torch.cuda.empty_cache()
    t_dist = time.perf_counter()
    dist_ = distributed_phases(torch, dev, counters)
    dist_["seconds"] = time.perf_counter() - t_dist
    print(json.dumps({"distribution": jsonable(dist_)}))

    # ---- 55-58. the rest of distribution
    torch.cuda.empty_cache()
    t_rest = time.perf_counter()
    dist_rest = distribution_rest_phases(torch, dev, counters)
    dist_rest["seconds"] = time.perf_counter() - t_rest
    print(json.dumps({"distribution_rest": jsonable(dist_rest)}))

    # ---- 59. K4 tiles at the balanced split's shapes
    torch.cuda.empty_cache()
    t_tiles = time.perf_counter()
    tiles59 = tile_kernel_phase(torch, dev, counters)
    tiles59["seconds"] = time.perf_counter() - t_tiles
    print(json.dumps({"tile_kernel": jsonable(tiles59)}))
    band47 = band["phase47"]["p = 4 + band 6"]

    print(json.dumps({"step_split": splits, "timer_cost_steps_per_s": cost,
                      "settled": settled,
                      "k1_409600": {str(k): v for k, v in k1_scale.items()},
                      "film": {str(S): v for S, v in film.items()},
                      "film_step_check": film_step_check,
                      "film_farfield": film_ff, "mixture": mixture,
                      "farfield_mixture": ff_mix, "poly_film": poly_film,
                      "stepper_modes": stepper_modes,
                      "examples": examples}))

    b1 = bound_ms(60 * n * n, 36 * n)
    b1_2 = bound_ms(90 * n * n, 60 * n)
    b2 = bound_ms(90 * n * n, 84 * n)
    print(f"K1 {k1_ms:.4f} / {k1_ms2:.4f} ms, {k1_ms / b1[0]:.2f}x / "
          f"{k1_ms2 / b1_2[0]:.2f}x its bounds; K2 "
          f"{k2_ms:.4f} ms, {k2_ms / b2[0]:.2f}x; K3 {k3[1]['ms']:.4f} / "
          f"{k3[2]['ms']:.4f} ms, {k3[1]['ms'] / k3[1]['bound'][0]:.2f}x / "
          f"{k3[2]['ms'] / k3[2]['bound'][0]:.2f}x; K4 {k4[1]['ms']:.4f} / "
          f"{k4[2]['ms']:.4f} ms, {k4[1]['ms'] / k4[1]['bound'][0]:.2f}x / "
          f"{k4[2]['ms'] / k4[2]['bound'][0]:.2f}x; P {p_ms:.4f} ms, "
          f"{p_ms / bp[0]:.2f}x")
    summary = {"kernels": [
        {"name": "pair_sweep_sym", "route": "cuda", "source": SOURCE,
         "replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:312",
         "launches": counts["pair_sweep_sym"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": b1[0],
         "bound_by": b1[1], "library_ms": None, "ms_2rhs": k1_ms2,
         "plain_ms_2rhs": k2_plain_ms, "bound_ms_2rhs": b1_2[0],
         "bound_ratio": k1_ms / b1[0],
         "bound_ratio_2rhs": k1_ms2 / b1_2[0], "redesigned_in": 5,
         "launches_settled": counts_s["pair_sweep_sym"],
         "launches_rigid_body_run": rigid["run"]["launches"].get(
             "pair_sweep_sym", 0),
         **box_entries(film_k, film, "K1", "k1"),
         "ms_409600": k1_scale[1]["ms"],
         "ms_2rhs_409600": k1_scale[2]["ms"],
         "peak_bytes_409600": k1_scale[1]["peak_bytes"],
         "peak_bytes_2rhs_409600": k1_scale[2]["peak_bytes"],
         **poly_entries(poly_t, "K1", mixture["k1_poly"]),
         **poly_box_entries(pf_t, pf_errs, "K1", poly_film["k1_poly_box"],
                            poly_film["k1_poly_box_per_step"]),
         "ms_function_forward": adj["forward_ms"],
         "ms_function_backward": adj["backward_ms"],
         "ms_function_backward_force_only": adj["backward_force_only_ms"],
         "function_backward_peak_bytes": adj["backward_peak_bytes"],
         "launches_function_backward": adj["backward_launches"].get(
             "pair_sweep_sym", 0),
         "launches_adjoint_solve_forward": adj["solve_forward_launches"].get(
             "pair_sweep_sym", 0),
         "launches_adjoint_solve_backward": adj[
             "solve_backward_launches"].get("pair_sweep_sym", 0),
         "launches_adjoint_trajectory_forward": adj[
             "trajectory_forward_launches"].get("pair_sweep_sym", 0),
         "launches_adjoint_trajectory_backward": adj[
             "trajectory_backward_launches"].get("pair_sweep_sym", 0),
         "ms_adjoint_trajectory_backward": adj["trajectory_backward_ms"]},
        {"name": "pair_sweep_ordered", "route": "cuda", "source": SOURCE,
         "replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:175",
         "launches": counts["pair_sweep_ordered"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": b2[0],
         "bound_by": b2[1], "library_ms": None,
         "bound_ratio": k2_ms / b2[0], "redesigned_in": 5,
         "launches_settled": counts_s["pair_sweep_ordered"],
         "launches_rigid_body_run": rigid["run"]["launches"].get(
             "pair_sweep_ordered", 0),
         **box_entries(film_k, film, "K2", "k2"),
         **poly_entries(poly_t, "K2", mixture["k2_poly"]),
         **poly_box_entries(pf_t, pf_errs, "K2", poly_film["k2_poly_box"],
                            poly_film["k2_poly_box_per_step"])},
        {"name": "near_sweep", "route": "cuda", "source": K3_SOURCE,
         "replaces": "rigid_body_light_tpu/ops/rpy_pallas.py:908",
         "launches": counts_f["near_sweep"], "max_abs_err": k3[1]["err"],
         "ms": k3[1]["ms"], "plain_ms": k3[1]["plain_ms"],
         "bound_ms": k3[1]["bound"][0], "bound_by": k3[1]["bound"][1],
         "library_ms": None, "ms_2rhs": k3[2]["ms"],
         "plain_ms_2rhs": k3[2]["plain_ms"],
         "bound_ms_2rhs": k3[2]["bound"][0],
         "bound_ratio": k3[1]["ms"] / k3[1]["bound"][0],
         "bound_ratio_2rhs": k3[2]["ms"] / k3[2]["bound"][0],
         "redesigned_in": 4, "box_form_in": 8,
         "ms_box": k3b[1]["ms"], "ms_2rhs_box": k3b[2]["ms"],
         "plain_ms_box": k3b[1]["plain_ms"],
         "plain_ms_2rhs_box": k3b[2]["plain_ms"],
         "bound_ms_box": k3b[1]["bound"][0],
         "bound_ms_2rhs_box": k3b[2]["bound"][0],
         "bound_ratio_box": k3b[1]["ms"] / k3b[1]["bound"][0],
         "bound_ratio_2rhs_box": k3b[2]["ms"] / k3b[2]["bound"][0],
         "max_abs_err_box": k3b[1]["err"],
         "max_abs_err_2rhs_box": k3b[2]["err"],
         "launches_rigid_body_step": rigid_ff["deterministic_step"][
             "launches"].get("near_sweep", 0),
         "launches_film_farfield": film_ff["k3"],
         "launches_per_step_film_farfield": film_ff["k3_per_step"],
         "launches_band_slice": band47["launches"].get("near_sweep", 0),
         "launches_per_step_band_slice": band47["k3_per_step"],
         **k3_poly_entries(k3p, k3p_err, k3pb, k3pb_err, ff_mix)},
        distributed_entries(dist_),
        {"name": "ewald_real_sweep", "route": "cuda", "source": K4_SOURCE,
         "replaces": "rigid_body_light_tpu/ops/ewald_pallas.py:81",
         "launches": counts_e["ewald_real_sweep"], "max_abs_err": k4_err,
         "ms": k4[1]["ms"], "plain_ms": k4[1]["plain_ms"],
         "bound_ms": k4[1]["bound"][0], "bound_by": k4[1]["bound"][1],
         "library_ms": None, "ms_2rhs": k4[2]["ms"],
         "plain_ms_2rhs": k4[2]["plain_ms"],
         "bound_ms_2rhs": k4[2]["bound"][0],
         "bound_ratio": k4[1]["ms"] / k4[1]["bound"][0],
         "bound_ratio_2rhs": k4[2]["ms"] / k4[2]["bound"][0],
         "redesigned_in": 4,
         "launches_balanced_split_slice": balanced["phase44"][
             "launches"].get("ewald_real_sweep", 0)},
        slice_entry(dist_),
        ewald_slab_entry(dist_rest),
        tiles_entry(balanced, tiles59),
        {"name": "fma_peak", "route": "cuda", "source": P_SOURCE,
         "replaces": "scripts/tpu_kernel_roofline.py:53",
         "launches": p_launches, "max_abs_err": p_err, "ms": p_ms,
         "plain_ms": p_plain_ms, "bound_ms": bp[0], "bound_by": bp[1],
         "library_ms": None, "measured_tflops": p_tflops,
         "bound_ratio": p_ms / bp[0]},
    ]}
    print(f"chip_smoke: total wall time {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
