#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (pmesh_tpu_torch) end to end on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. a CUDA device must be present (there is no CPU path); print the
   card's name and power limit as nvidia-smi reports them;
2. build the CUDA kernels from pmesh_tpu_torch/csrc with nvcc, one
   nvcc per source, all at once;
3. hold each kernel against its plain PyTorch version on the same
   tensors on the card, and time both: the lattice paint and readout
   (one mesh, diffdir 0 and 'all', and three meshes in one launch, as
   the spectral force reads them) at 512^3 f32 CIC for three
   displacement bounds (nv = 3 and 5) and at 128^3 with nv = 7 (a width
   the kernels read at run time), the
   binned rebase assign and apply at 512^3, K = 2 plus velocities,
   bitwise, for drift bounds (-0.5, 1.5) with 2 and 3 output slots and
   (-1, 2), and the four DFT passes of fft='mxu' on a 512^3 density
   (the forward zy and x passes, the dual inverse x pass with 1/k^2,
   the zy inverse with and without the Nyquist plane and the dual zy
   inverse) and on a (16, 512, 1024) slab, whose z inverse is the z-CT
   form; the three dense DFT passes (fft='mxu' at shapes that are not
   ct2: the zy forward, the x pass forward and dual inverse with 1/k^2,
   the zy inverse with the fx, fy and fz tables) on a 384^3 density
   and on a ragged (96, 80, 75) mesh; beside each kernel its bound
   (compulsory bytes over 3.35 TB/s or the operations the function
   needs over 67 TFLOP/s FP32, the larger; for a DFT pass those of the
   FFTs computing the same transform) and, where one PyTorch call computes the
   same function, that call's time (torch.fft); and for each pipeline
   the operator-level yardsticks torch.fft.rfftn(x, norm='forward') and
   the stacked irfftn of the filtered spectrum, the filter timed apart;
   the forward ct2 passes, the dense forward passes (zy_fwd_half,
   x_dense, on tc_gemm) and the zy inverses (zy_inv_ct2, its dual,
   zy_inv_half, on tc_gemm) also print their tensor-core share, the
   f32 forward cases each one's distance from f64 products beside
   plain's (the kernel no farther), and the tc_gemm passes their kernel
   launches at the main, row-9 and row-13 shapes in both forms (counted
   by the C entry points by kind: tc_gemm and the split passes; the
   FP32 cgemm and cgemm_bf16 are retired, and phases 4, 5 and 9 hold
   every fft='mxu' mode's run to the tensor-core kinds);
4. drive the FastPM lattice path at 512^3 f32 through the user's entry
   points: Solver.lpt_lattice (2LPT) then Solver.nbody_lattice (5 KDK
   steps, spectral force) and one gradient-mode force_lattice, with
   the kernels' launch counters read around the run; check that the
   state is finite, that a paint of it conserves mass and that the
   kernels carried the run; time one KDK step with CUDA events; then
   the same run with fft='mxu' (the DFT kernels in place of cuFFT),
   held against the fft='xla' run and timed beside it;
5. drive the binned path on a clustered state with fft='mxu', as
   bench.py's measure_binned_clustered does: the 384^3 caustic flow
   through Solver.nbody_binned(adaptive=True), counters read around
   the run; check that the slots grew, that nothing overflowed, that
   the particle count is exact, that a paint conserves it and that the
   rebase, lattice and dense DFT kernels carried the run (the DFT
   launches exactly three forces' worth); hold force_binned(fft='mxu')
   against fft='xla' on the grown state; time one KDK step of a
   superstep at the grown K with both FFTs (bench.py's ms_per_step) and
   the peak memory, and profile one superstep per FFT (device time by
   kernel family, idle share);
6. time the binned path at 512^3, K = 2, occupancy 1: one superstep
   (two KDK steps and a rebase) of Solver.nbody_binned, force_binned
   in both modes (fft='xla' and fft='mxu'), the rebase alone, and the
   peak device memory;
7. run the lattice path at 32^3 (fft='xla'), at (256, 256, 16)
   (fft='mxu', ct2) and at (48, 40, 33) (fft='mxu', dense), and the
   binned path at 32^3, on the card and on the CPU (plain versions,
   pocketfft) from the same seed and compare; and the gradient of a
   2-step lattice run at 32^3 (fft='xla') and (256, 256, 16)
   (fft='mxu', ct2), card against CPU.

Row 13 (pmesh_tpu/ops/fft_mxu_ref.py, the older full-spectrum and
first-CT pipelines) and reverse mode add to phases 3 and 4: phase 3
also holds the row-13 passes against their plain versions (the
full-spectrum zy forward, x pass and zy inverse on the 512^3 density and
a ragged (96, 80, 75) mesh; the half-CT zy forward, CT x pass and zy
inverse on the 512^3 density and (256, 512, 30)), with their bounds,
torch.fft yardsticks (fftn, ifftn(...).real, rfftn, irfftn) and
operator-level yardsticks; phase 4c drives the row-13 entry points on
the overdensity of phase 4's LPT state (the force held against
force_lattice(fft='xla'), the half-CT triple against the ct2 triple,
the full round trip against the overdensity, counters read around the
run); phase 4d takes torch.autograd.grad of a 2-step nbody_lattice loss
with respect to the initial (disp, vel) at 512^3 with fft='xla' and
fft='mxu' (finite; the two within 1e-3 of max|g| but for 1e-5 of the
entries with CIC, whose derivative jumps at cell boundaries, and for
none with TSC; the backward's paint, readout and only=d DFT launches
counted; forward and forward + backward per KDK step; peak memory).

The bf16 forms of the DFT kernels (fft='mxu_bf16': bf16 tensor-core
products in every DFT kernel; fft='mxu_bf16s': the ct2 spectra stored
in bf16) add to phases 3, 4, 4c, 5 and 7: phase 3 holds each form of
each kernel against its plain version on the f32 rows' shapes, each
pass on the same inputs (bf16 products within TOL_BF16 of max, a
bf16-stored spectrum bitwise but for BF16_SHARE of its entries), with
its bound and torch.fft yardstick; phase 4 runs the 512^3 path with
each mode (the launch counters show that form alone carried it; the
force and state against fft='mxu' printed; the kernels' force meshes
held against the plain versions' on the card, and the overdensity's
against f32 to a sanity bound); phase 4c runs the row-13 path with
precision='bf16'; phase 5 one force_binned(fft='mxu_bf16') on the grown
clustered state (the dense bf16 form); phase 7 small runs and a
gradient, card against CPU, to the chained bound of TOL_CHAIN.

The slab-sharded path (rank-local slabs over torch.distributed) adds
three phases:

8. every slab kernel against its plain version at the shapes of RANKS
   ranks: the x-halo lattice paint and readout and the x-halo rebase on
   a 128-row slab of the 512^3 main path (also bitwise the wrapped
   kernels' rows of the whole mesh), the row-9 dense passes at the slab
   and y-chunk shapes of 384^3 and the ct2 passes at those of 512^3,
   with bounds and torch.fft yardsticks;
9. RANKS ranks on the card (parallel/launch.spawn over gloo; one card
   cannot host NCCL ranks, so the collectives are staged through the
   host): lpt_lattice + 3 KDK steps of nbody_lattice at 512^3 with
   fft='mxu' (ct2) and 'xla' and one 'mxu_bf16s' force, the 384^3 dense
   force_lattice(fft='mxu') (row 9), one sharded rebase and a binned
   superstep at 512^3, K = 2 (row 12), gathered to rank 0 and held
   against the single-device kernels on the card (forces and paints on
   the same inputs to 1e-5 of max, states to 1e-4, the binned density
   to 1e-4, the rebase bitwise), the launch counters set to 0 just
   before each run and read just after it, summed over the ranks and
   held to the exact count of its forces and rebases; the ranks run
   this script's card_phases;
10. the per-rank chain of the 8-rank 1024^3 sharded force step at its
   (128, 1024, 1024) slab shapes (bench.py's measure_pipe_chain),
   kernel by kernel with bounds, beside torch.fft's calls.

The catalog FastPM path (the particles as (N, 3) tensors; the generic
paint and readout of ops/paint.py, index_add_ and gathers, and cuFFT;
no hand kernel, as the JAX package reaches no Pallas kernel there) adds
phase 11, run beside phases 4, 6 and 7:

11. the reference's configuration of a run: 256^3 particles in a 512
   Mpc/h box, f4, a B = 2 force mesh (512^3 CIC), Planck15 and EHPower
   at sigma8 0.8159, gadget white noise of seed 42, 2LPT at a = 0.1,
   Solver.nbody over 10 KDK steps to a = 1 and one gradient-mode force;
   checked finite, a paint of the final state conserving mass to 1e-5,
   and fftpower of the final over the initial density in the three
   lowest k bins within 5 % of (D1(1)/D1(0.1))^2; the KDK step, one
   paint, the three-mesh readout, the forces and the gadget and native
   white-noise fills timed (the paint and readout beside their bounds),
   the peak memory read and one step profiled by kernel family (the
   paint, readout and FFT families must each run on the card); the
   catalog force on phase 4's 512^3 LPT state held against
   force_lattice(fft='xla') within 1e-3 of max|F|; a 32^3 catalog run,
   card against CPU within 1e-4, and the native white noise at 64^3,
   card against CPU, bitwise in its uniforms.

The applications on the port's field core add phase 12, run after
phase 11:

12. (a) gravpm's catalog mode (models/gravpm.run_sim) at phase 11's
   configuration with bigfile snapshots at a = 0.5 and 1, read back with
   read_ic: the final Position/Velocity/ID and both P(k) blocks bitwise
   what was written, mass conserved, and the three lowest k bins of
   P(1)/P(0.55) within 5 % of (D1(1)/D1(0.55))^2; its ms per KDK step
   from the run's own timers; (b) its lattice mode with fft='mxu' at
   512^3 from a = 0.1 to 0.2 (5 KDK steps): the box is 1024 Mpc/h unless
   the run's displacement bounds (the LPT extremes x 1.3 x growth) need
   more than NV_MAX CIC offsets per axis, then 2048; finite, no warning,
   mass conserved, and the launch counters, set to 0 just before the run
   and read just after, showing the lattice paint and readout and the
   four ct2 DFT kernels; (c) resample, upsample/downsample, preview,
   cgetitem/csetitem, a c2c round trip, every *_vjp/*_jvp method and
   Klein-Gordon's ring soliton (32^2, 21 steps) at 32^3 f8, card against
   CPU within 1e-10, and the vjp/jvp methods against central differences
   on the card within 1e-5.

Reverse mode beyond the lattice, and the legacy package, add phase 13,
run after phase 11's small runs:

13. (a) the catalog forward model at phase 11's configuration: the
   256^3 gadget white noise of seed 42 as a real field, shaped as
   Solver.linear_field shapes it, 2LPT at a = 0.1 and 2 KDK steps, the
   paint on the 512^3 force mesh; the gradient of sum (rho - 1)^2 in the
   noise, finite, its directional derivative along a seeded v against
   torch.func.jvp (1e-3) and against an f8 central difference at full
   width (5e-3); forward and forward + backward ms per KDK step, the
   2LPT's forward + backward, the peak; (b) force_binned at 512^3, K = 2,
   from phase 6's state under autograd with fft='xla' and 'mxu': the
   lattice kernels (and the four ct2 DFT kernels) launched forward and
   backward exactly as counted in advance and nothing else, finite, mxu
   against xla as phase 4d holds them, ms and peak; nbody_binned under
   autograd refuses at the CUDA rebase; (c) the catalog model's gradient
   and force_binned's at 32^3, card against CPU within 1e-4 of max|g|;
   (d) the legacy package's ParticleMesh pipeline at 512^3 with 256^3
   particles against the same computation through the modern API, and a
   legacy lanczos3 paint at 64^3, card against CPU, within 1e-5.

The catalog path on the slab-sharded mesh (the ghost exchange of
parallel/exchange.py; no hand kernel, as the JAX package's sharded
catalog path reaches no Pallas kernel) adds phase 14, run after phase
10:

14. RANKS ranks on the card over gloo, staged through the host as in
   phase 9, at phase 11's configuration: Solver.linear_field, lpt and
   nbody with tune_exchange and rebalance over 3 KDK steps to a = 0.4
   (SHARDED_CAT_STEPS, cut from phase 11's 10 when phase 16 joined),
   each rank on block b of the particles and slab b of the
   meshes; the sharded gadget and native noise bitwise the
   single-device fills, the 2LPT state and the state after 3 KDK steps,
   gathered to rank 0 by ID, within 1e-4 of max of phase 11's
   single-device states, one force on the sharded 2LPT state within
   1e-4 of max|F| of the single-device force on the same particles; at
   the end finite, on the card, mass conserved to 1e-5 and the three
   lowest k bins of the final over the initial density within 5 % of
   (D1(0.4)/D1(0.1))^2; kside, capacity, the ghosts and the load per rank,
   the rebalances, the bytes staged per force, the ms per KDK step and
   the peak memory per rank printed.

The catalog path on the other geometries (ROADMAP item 8a: the 2-d
pencil grid with the ghost exchange of parallel/exchange2d.py, padded
uneven slabs, the replicated route; no hand kernel, as the JAX package
reaches none there) adds phase 15, run after phase 14:

15. (a) phase 14's run and checks on 4 ranks as a (2, 2) pencil grid,
   the ksides and the per-channel capacities and ghosts printed; (b)
   the same on 5 ranks, where the 512^3 force mesh has 103-row slabs
   (the last with 100 rows on the mesh) and the 256^3 particle mesh
   52-row slabs (the last with 48); (c) on 3 ranks, where 512^3 takes
   the replicated route: decompose's RuntimeWarning and one force on
   phase 11's 2LPT state within 1e-4 of max|F| of the one-device force;
   and on 4 ranks of the slab grid a 32^3 c2c round trip and a 32^2
   r2c and c2r, card against CPU, within 1e-10 in f8.

Reverse mode on the sharded routes (ROADMAP item 8c) adds phase 16,
run after phase 15, on gloo ranks of the one card staged through the
host as phases 9, 14 and 15 are:

16. (a) phase 4d's loss on 4 slab ranks at 512^3: the sharded 2LPT
   state of phase 4's linear field, 2 KDK steps of nbody_lattice with
   fft='mxu' (ct2); the gathered gradient against phase 4d's one-device
   gradient (saved to disk) by phase 4d's criterion, the launches of
   the backward alone, summed over the ranks, exactly the x-halo paint
   and readout and the ct2 transposes' passes counted in advance; one
   force's gradient with fft='xla' beside fft='mxu'; (b) phase 13(a)'s
   model on 4 slab ranks and on a (2, 2) pencil grid, in f8: the
   gradient in the noise within 1e-3 of max|g| of phase 13(a)'s f8
   gradient, <grad L, v> (and on the slabs one torch.func.jvp) along
   phase 13(a)'s v within 1e-4 of its f8 values; in f4, the model's
   dtype, on the slabs the times and the f4 gradient's gap to phase
   13(a)'s (printed: float32 atomics and CIC cell crossings put the two
   f4 gradients 1e-3 apart, which the f8 gaps show to be rounding);
   (c) the f8 32^3 catalog model's gradient on 5 uneven slab ranks and on
   3 ranks of the replicated route, card against CPU within 1e-8, and
   force_binned's backward at 128^3 on 4 slab ranks against the CPU as
   phase 13(c) holds it (1e-4 of max|g|: its kernels are f32), its
   launches the x-halo kernels' exactly.  Each part prints the ms per
   KDK step (or per call) forward and forward + backward, the bytes the
   backward staged per rank and the peak per rank.

17. the f64 forms and the field API on the sharded routes: (a) the f64
   lattice kernels (paint with a mass mesh, readouts of one and three
   meshes and 'all') at 512^3 CIC for nv 3 and 5, the run-time width at
   128^3 (nv 7), the x-halo forms on a 128-row slab of 512^3 and the f64
   rebase at 512^3 (K = 2 -> 2 and -> 3 with velocities) against their
   plain versions (1e-12 of max; the rebase bitwise), kernel ms beside
   plain ms and the bound (bytes / 3.35 TB/s or operations / 34 TFLOP/s,
   NVIDIA's published H100 SXM FP64 rate outside the tensor cores);
   (b) phase 4's path in f8 at 512^3 (lpt_lattice + 5 KDK steps) and a
   binned superstep (K = 2, two KDK steps and an f64 rebase), each on
   the f64 kernels (counters read around the run) against the same run
   with the plain route on the card (1e-10), finite, mass conserved to
   1e-12, ms per KDK step beside phase 4's f32; one fft='mxu' force of
   the f8 density (cast to f32 at the pass boundary, as the JAX package
   casts it) against the f8 fft='xla' force; (c) phase 4d's loss in f8
   at 256^3: <grad L, v> along a seeded v against the f8 central
   difference (1e-6 with TSC; with CIC, whose weights' slopes jump at
   the cell boundaries that a step crosses, printed and held to 1e-3);
   (d) f8 force_lattice, nbody_lattice and
   nbody_binned at 32^3 against the CPU (1e-10), and a 2-d lattice run
   (256^2 against the CPU, 4096^2 timed) on the plain route, with no
   kernel launch, as the JAX package runs XLA there; (e) ravel/unravel,
   mesh_coordinates, cgetitem/csetitem (seeded indices and their duals),
   ctranspose, preview, resample and the untransposed layout on 4 slab
   ranks of the card over gloo at phase 11's 512^3 force mesh in f4
   (exact where they move data, 1e-5 of the one-device card run where
   they compute), with the f8 lattice and binned runs at 64^3 on the
   x-halo f64 kernels beside them, and the same set at 32^3 in f8 on a
   (2, 2) pencil grid, 5 uneven slab ranks and 3 replicated ranks
   against the CPU (1e-10); each call's ms and the bytes staged.

The second-to-last line is the kernels' JSON record, the last line
the device record.
"""
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
import sys
import time

import numpy as np
import torch

N = 512
BOX = 1024.0            # Mpc/h: 2 Mpc/h cells
BOUNDS = (-1.0, 1.0)    # main-path displacement bounds, nv = 3
COMPARE_BOUNDS = ((-1.0, 1.0), (0.0, 2.0), (-2.0, 2.0))
A0 = 0.1
STEPS = np.linspace(0.1, 0.2, 6)   # 5 KDK steps
SIGMA0 = 0.05           # rms first-order displacement at A0, cells
SPECTRAL_INDEX = -1.0   # P(k) ~ k^n of the linear field
SEED = 42
TOL_KERNEL = 1e-5       # max|kernel - plain| / max|plain|
TOL_MASS = 1e-5
TOL_SMALL = 1e-4        # 32^3 card vs CPU, of max|S| (binned: max|rho|)
# the clustered binned state (the caustic flow of bench.py's
# measure_binned_clustered) and the timed one (measure_binned)
NC, CAUSTIC_AX, CAUSTIC_LAM = 384, 1.6, 8
# the binned rebase: drift bounds, fill per input slot, output slots,
# mesh size (the first is the main path's, the last the clustered
# path's K = 4 -> 4 at NC^3)
REBASE_CASES = (((-0.5, 1.5), (1.0, 0.25), 2, N),
                ((-0.5, 1.5), (1.0, 0.25), 3, N),
                ((-1.0, 2.0), (1.0, 0.25), 3, N),
                ((-0.5, 1.5), (1.0, 0.25, 0.1, 0.05), 4, NC))
BINNED_KW = dict(nslots=2, rebase_every=2, step_drift=0.25, fft='xla')
CLUSTERED_KW = dict(BINNED_KW, fft='mxu')
CLUSTERED_STEPS = [0.5, 0.52, 0.54]    # 2 KDK steps, 3 forces
SUPERSTEP_STEPS = [0.5, 0.55, 0.6]     # bench.py's timed superstep
SUPERSTEP_BOUNDS = (-0.5, 1.5)

KERNELS = {
    "paint_lattice": ("pmesh_tpu_torch/csrc/gridpm.cu",
                      "pmesh_tpu/ops/gridpm_pallas.py:491"),
    "readout_lattice": ("pmesh_tpu_torch/csrc/gridpm.cu",
                        "pmesh_tpu/ops/gridpm_pallas.py:171"),
    # the spectral force's form: three meshes in one launch
    "readout_lattice (3 meshes)": ("pmesh_tpu_torch/csrc/gridpm.cu",
                                   "pmesh_tpu/ops/gridpm_pallas.py:171"),
    # their bf16 storage form (_cdtype, gridpm_pallas.py:91)
    "paint_lattice_bf16": ("pmesh_tpu_torch/csrc/gridpm.cu",
                           "pmesh_tpu/ops/gridpm_pallas.py:491"),
    "readout_lattice_bf16": ("pmesh_tpu_torch/csrc/gridpm.cu",
                             "pmesh_tpu/ops/gridpm_pallas.py:171"),
    "rebase_assign": ("pmesh_tpu_torch/csrc/binned.cu",
                      "pmesh_tpu/ops/binned_pallas.py:375"),
    "rebase_apply": ("pmesh_tpu_torch/csrc/binned.cu",
                     "pmesh_tpu/ops/binned_pallas.py:519"),
    "zy_fwd_ct2": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                   "pmesh_tpu/ops/fft_mxu.py:1088"),
    "xct_multi": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                  "pmesh_tpu/ops/fft_mxu.py:854"),
    "zy_inv_ct2": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                   "pmesh_tpu/ops/fft_mxu.py:1127"),
    "zy_inv_ct2_dual": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                        "pmesh_tpu/ops/fft_mxu.py:1031"),
    # the dense pipeline: fft3_real_forward_half (row 3), the x-pass
    # kernel _x_transform that both rows 3 and 4 call, and
    # fft3_real_inverse_grad3_half's zy pass (row 4)
    "zy_fwd_half": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                    "pmesh_tpu/ops/fft_mxu.py:496"),
    "x_dense": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                "pmesh_tpu/ops/fft_mxu.py:155"),
    "zy_inv_half": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                    "pmesh_tpu/ops/fft_mxu.py:540"),
    # row 13, fft_mxu_ref.py: the full-spectrum passes and the first-CT
    # half passes; the two x passes are x_dense and xct_multi at the
    # row's widths, recorded apart from the rows they were built for
    "zy_fwd_full": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                    "pmesh_tpu/ops/fft_mxu_ref.py:38"),
    "x_dense (full spectrum)": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                                "pmesh_tpu/ops/fft_mxu_ref.py:99"),
    "zy_inv_full": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                    "pmesh_tpu/ops/fft_mxu_ref.py:55"),
    "zy_fwd_half_ct": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                       "pmesh_tpu/ops/fft_mxu_ref.py:233"),
    "xct_multi (half CT)": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                            "pmesh_tpu/ops/fft_mxu_ref.py:246"),
    "zy_inv_half_ct": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                       "pmesh_tpu/ops/fft_mxu_ref.py:280"),
    # the slab-sharded path: the x-halo slab forms of the lattice paint
    # and readout (paint_fused_parts / readout_fused_parts with halos,
    # reached through _shift_sharded), row 9 (the dense passes at the
    # slab and y-chunk shapes) and row 12 (the fused sharded rebase,
    # both of whose halves the x-halo rebase kernels replace)
    "paint_lattice_xhalo": ("pmesh_tpu_torch/csrc/gridpm.cu",
                            "pmesh_tpu/ops/gridpm_pallas.py:410"),
    "readout_lattice_xhalo": ("pmesh_tpu_torch/csrc/gridpm.cu",
                              "pmesh_tpu/ops/gridpm_pallas.py:347"),
    "zy_fwd_half (row 9)": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                            "pmesh_tpu/ops/fft_mxu.py:1568"),
    "x_dense (row 9)": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                        "pmesh_tpu/ops/fft_mxu.py:1586"),
    "zy_inv_half (row 9)": ("pmesh_tpu_torch/csrc/fft_mxu.cu",
                            "pmesh_tpu/ops/fft_mxu.py:1604"),
    "rebase_assign_xhalo": ("pmesh_tpu_torch/csrc/binned.cu",
                            "pmesh_tpu/ops/binned_pallas.py:84"),
    "rebase_apply_xhalo": ("pmesh_tpu_torch/csrc/binned.cu",
                           "pmesh_tpu/ops/binned_pallas.py:84"),
    # the f64 forms (f8 meshes and states, which reach the JAX package's
    # Pallas kernels too): the lattice ones built apart (gridpm64.cu),
    # the rebase in binned.cu; their x-halo slab forms
    "paint_lattice_f64": ("pmesh_tpu_torch/csrc/gridpm64.cu",
                          "pmesh_tpu/ops/gridpm_pallas.py:491"),
    "readout_lattice_f64": ("pmesh_tpu_torch/csrc/gridpm64.cu",
                            "pmesh_tpu/ops/gridpm_pallas.py:171"),
    "readout_lattice_f64 (3 meshes)": ("pmesh_tpu_torch/csrc/gridpm64.cu",
                                       "pmesh_tpu/ops/gridpm_pallas.py:171"),
    "paint_lattice_xhalo_f64": ("pmesh_tpu_torch/csrc/gridpm64.cu",
                                "pmesh_tpu/ops/gridpm_pallas.py:410"),
    "readout_lattice_xhalo_f64": ("pmesh_tpu_torch/csrc/gridpm64.cu",
                                  "pmesh_tpu/ops/gridpm_pallas.py:347"),
    "rebase_assign_f64": ("pmesh_tpu_torch/csrc/binned.cu",
                          "pmesh_tpu/ops/binned_pallas.py:375"),
    "rebase_apply_f64": ("pmesh_tpu_torch/csrc/binned.cu",
                         "pmesh_tpu/ops/binned_pallas.py:519"),
    "rebase_assign_xhalo_f64": ("pmesh_tpu_torch/csrc/binned.cu",
                                "pmesh_tpu/ops/binned_pallas.py:84"),
    "rebase_apply_xhalo_f64": ("pmesh_tpu_torch/csrc/binned.cu",
                               "pmesh_tpu/ops/binned_pallas.py:84"),
}
# the bf16 forms of the DFT kernels: the bf16 products (fft='mxu_bf16',
# precision='bf16') of each, "<kernel>_bf16", and the bf16 spectrum
# storage (fft='mxu_bf16s') of the four ct2 ones, "<kernel>_bf16s"
CT2 = ("zy_fwd_ct2", "xct_multi", "zy_inv_ct2", "zy_inv_ct2_dual")
DENSE = ("zy_fwd_half", "x_dense", "zy_inv_half")
# the launch counter of a KERNELS entry: its name up to the first space
ROW13 = ("zy_fwd_full", "x_dense (full spectrum)", "zy_inv_full",
         "zy_fwd_half_ct", "xct_multi (half CT)", "zy_inv_half_ct")


def bf16_name(name, form="_bf16"):
    """the KERNELS name of a kernel's bf16 form"""
    base, _, tail = name.partition(" ")
    return base + form + (" " + tail if tail else "")


for _name in CT2 + DENSE + ROW13:
    KERNELS[bf16_name(_name)] = KERNELS[_name]
for _name in CT2:
    KERNELS[bf16_name(_name, "_bf16s")] = KERNELS[_name]
# launches of the row-13 path (phase 4c): a full-spectrum force and round
# trip, a half-CT force
ROW13_PATH = {"zy_fwd_full": 2, "x_dense": 4, "zy_inv_full": 4,
              "zy_fwd_half_ct": 1, "xct_multi": 2, "zy_inv_half_ct": 3}
REF_SMALL = (96, 80, 75)      # the full pipeline at a ragged shape
CT_RAGGED = (256, 512, 30)    # the half-CT pipeline at R = 2 and 4
TOL_ROUNDTRIP = 2e-5
# the half-CT triple against the ct2 triple (i*k_d, no 1/k^2), of max,
# as tests/test_fft_mxu.py holds ct2 against the dense triple
TOL_CT_TRIPLE = 1e-5
# the gradient phase: 2 KDK steps, 3 forces
GRAD_STEPS = STEPS[:3]
# fft='mxu' against fft='xla', of max|g|.  The CIC window's derivative
# jumps where a displacement crosses a cell boundary, so a particle that
# the two runs' rounding puts on either side of one (LPT displacements
# cluster near 0) gets gradients an O(1) step apart: with CIC at most
# GRAD_OUTLIERS of the entries may lie outside the tolerance (the card
# against the CPU in phase 7 too); with TSC, whose derivative is
# continuous, none may (phase 4d)
TOL_GRAD = 1e-3
GRAD_OUTLIERS = 1e-5
# per force: forward, backward (the paint's and readout's vjps; the
# mxu triple's transpose, one forward and one only=d inverse per
# direction).  The forward reads its three meshes in one readout; the
# backward paints each mesh's cotangent and reads the three meshes once
# per derivative axis and once for the paint's ('all')
GRAD_LATTICE = {"paint_lattice": (1, 3), "readout_lattice": (1, 4)}
GRAD_MXU = {"zy_fwd_ct2": (1, 3), "xct_multi": (2, 6), "zy_inv_ct2": (1, 3),
            "zy_inv_ct2_dual": (1, 0)}
# per force on the fft='mxu' path: spectral, gradient
MXU_PER_FORCE = {"zy_fwd_ct2": (1, 1), "xct_multi": (2, 2),
                 "zy_inv_ct2": (1, 1), "zy_inv_ct2_dual": (1, 0)}
# per spectral force at a shape that is not ct2
DENSE_PER_FORCE = {"zy_fwd_half": 1, "x_dense": 2, "zy_inv_half": 3}
# the device kernels of those calls, by kind (fft_mxu_cuda.kernel_launches):
# zy_fwd_half's z and y stages, the two x passes and the three zy
# inverses' y and z stages on tc_gemm, each after its split pass, column
# 0 chained after the forward y stage and the forward x pass
DENSE_KINDS_PER_FORCE = {"tc_ct": 0, "tc_z": 0, "tc_gemm": 10, "split": 10,
                         "ct_fwd_col0": 2}
# the device kernels of one fft='mxu_bf16' ct2 force at N^3, each on
# tc_gemm after its split pass: zy_fwd_ct2's z-CT and y stages, the
# forward and dual x passes, zy_inv_ct2's y and z stages, its dual's one
# y stage (both sets) and two z stages
BF16_KINDS_PER_FORCE = {"tc_ct": 0, "tc_z": 0, "tc_gemm": 9, "split": 9,
                        "ct_fwd_col0": 0}
# the kinds of device kernels that the DFT entry points count: every
# product on the tensor cores (the FP32 cgemm and cgemm_bf16 are retired)
TC_KINDS = ("tc_ct", "tc_z", "tc_gemm", "split", "ct_fwd_col0")


def off_tensor_cores(kinds):
    """the kinds in ``kinds`` (a {kind: launches} dict) that are not
    the tensor-core routines', their split passes or column-0 chains"""
    return sorted(k for k, v in kinds.items() if v and k not in TC_KINDS)
# the bf16 forms against their plain versions, each pass on the same
# inputs.  A product of two bf16 values is exact in f32, so kernel and
# plain differ in their f32 sums only; but the tensor cores sum a block
# of products with their own alignment and rounding, further from a
# chain of FP32 FMAs than two such chains are from each other, so where
# a pass rounds an intermediate again (a zy pass: the z or y output is
# the next product's operand) more of those roundings flip, each by one
# bf16 ulp, which reaches every output of its row.  bf16 products: the
# rms gap within TOL_CHAIN_RMS of the rms of the bf16 rounding itself
# (the plain pass against its f32-product twin), the max gap within
# TOL_BF16 of max|plain| for an x pass (one product) and TOL_CHAIN for a
# zy pass; the share of entries beyond TOL_BF16_NEAR of max is printed.
# A bf16-stored spectrum: bitwise equal but for at most BF16_SHARE of
# its entries, none more than one bf16 ulp apart beyond the gap of the
# two f32 sums it rounds.  A chain of passes is held to TOL_CHAIN of
# max: the 512^3 force meshes also to TOL_FORCE_RMS of the bf16
# rounding; a small run card against CPU to the max alone (its bf16
# storage effect sits in a few rounded values of the mean density's
# column, which one flip moves by their whole size); against fft='mxu'
# on the main path the overdensity's bf16 force to a sanity bound,
# TOL_BF16_SANITY relative rms
TOL_BF16, TOL_BF16_NEAR, BF16_SHARE = 5e-4, 1e-5, 1e-3
TOL_CHAIN, TOL_CHAIN_RMS = 1e-2, 0.15
# the 512^3 force meshes chain five passes, each flipping roundings the
# next reads: their rms gap was 0.144 (mxu_bf16) and 0.132 (mxu_bf16s)
# of the bf16 rounding on an NVIDIA H100 80GB HBM3, 700 W
TOL_FORCE_RMS = 0.25
TOL_BF16_SANITY = 0.1
# checks of the bf16 forms that failed; the run goes on to its end and
# fails there, so that one run shows every measurement
DEFERRED = []
# the slab-sharded path: RANKS ranks on the card, N^3 ct2 lattice runs
# of SHARDED_STEPS (3 KDK steps), the NC^3 dense force, the N^3 binned
# superstep; the per-rank chain of the CHAIN_RANKS-rank 1024^3 step at
# its CHAIN_SLAB shapes (bench.py's measure_pipe_chain)
RANKS = 4
SHARDED_STEPS = STEPS[:4]
SHARDED_FFTS, SHARDED_EXTRA_FORCE = ('mxu', 'xla'), 'mxu_bf16s'
DENSE_BOUNDS = (0.0, 1.0)
CHAIN_RANKS, CHAIN_SLAB = 8, (128, 1024, 1024)
MXU_SLAB = (16, 512, 1024)
MXU_SMALL = (256, 256, 16)
DENSE_RAGGED = (96, 80, 75)
DENSE_SMALL = (48, 40, 33)
# the card's published peaks (NVIDIA H100 SXM data sheet) for the
# kernels' bounds: FP32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# and its dense bf16 tensor-core rate, for the split-precision products
PEAK_BF16 = 989e12
# the card's name and power limit (nvidia-smi), set by phase 1
CARD = "not read"
# operations counted for a bound: a lattice paint or readout those of
# paint_ops / readout_ops; a rebase assign 6 per input slot-cell (a
# floor and a subtraction per axis); a rebase apply none; a DFT pass
# those of the FFTs computing the same transform (fft_ops; its
# elementwise folds and scales, a few per element, are not counted), not
# those of its products, which grow as n^2 per axis
REBASE_OPS = 6


def paint_ops(nv, points, mass=False):
    """the operations a CIC lattice paint of ``points`` outputs needs at
    nv offsets per axis: per source cell its 3 nv axis weights (1 - |t|,
    2 each); per (output, offset) the product of the source's three
    weights (2), its product with a mass mesh (1), and the accumulate"""
    return points * ((4 if mass else 3) * nv ** 3 + 6 * nv)


def readout_ops(nv, points, nmesh=1, diff_all=False):
    """the operations a CIC lattice readout of ``points`` particles
    needs at nv offsets per axis: per particle its 3 nv axis weights
    (twice for 'all', the derivatives beside them; 2 each) and the nv^2
    products of x and y weights; per (particle, offset) the product with
    the z weight, then per mesh the product with the value and the
    accumulate.  'all' forms three such weight sets on one mesh"""
    sets = 3 if diff_all else 1
    return points * (sets * ((1 + 2 * nmesh) * nv ** 3 + nv ** 2)
                     + (12 if diff_all else 6) * nv)
# phase 3's window read at run time (not one of the compiled widths):
# CIC in WIDE_BOUNDS, nv = 7, on a WIDE_N^3 mesh
WIDE_BOUNDS, WIDE_N = (-3.0, 3.0), 128


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, after one warm-up."""
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


def nbytes(*objs):
    """bytes of the tensors and numpy arrays in nested tuples"""
    total = 0
    for o in objs:
        if o is None:
            continue
        if isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        else:
            total += np.asarray(o).nbytes
    return total


def record(err, ms, plain_ms, moved, ops, library_ms=None):
    """a kernel's record for the JSON line: its bound is the larger of
    ``moved`` bytes over PEAK_BYTES and ``ops`` over PEAK_FLOPS"""
    by_bytes = moved / PEAK_BYTES * 1e3
    by_ops = ops / PEAK_FLOPS * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=library_ms)


def linear_field(pm, gen):
    """Seeded white noise shaped to P(k) ~ k^SPECTRAL_INDEX, scaled so
    the rms first-order displacement at A0 is SIGMA0 cells."""
    from pmesh_tpu_torch import RealField
    from pmesh_tpu_torch.ops import transfer as tf
    noise = torch.randn(tuple(int(n) for n in pm.Nmesh), generator=gen,
                        device=pm.device, dtype=pm.torch_dtype)
    half = SPECTRAL_INDEX / 4.0   # |delta_k| ~ (k^2)^(n/4)
    dk = pm.create(type=RealField, value=noise).r2c().apply(
        lambda k, v: v * torch.where(k.normp(2) > 0,
                                     k.normp(2, zeromode=1.0) ** half, 0.0))
    cell = float(pm.BoxSize[0] / pm.Nmesh[0])
    sigma = float(dk.apply(tf.dx1_transfer(0)).c2r().value.std()) / cell
    from pmesh_tpu_torch.models.cosmology import Planck15
    scale = SIGMA0 / (sigma * Planck15.D1(A0))
    return pm.create(type=type(dk), value=dk.value * scale)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log(CARD)
    log("phase 1 device: %s, torch %s, CUDA %s, %d device(s)"
        % (torch.cuda.get_device_name(0), torch.__version__,
           torch.version.cuda, torch.cuda.device_count()))


def phase_build():
    from pmesh_tpu_torch.native import cuda
    # the f64 lattice kernels from nv 6 on build apart (gridpm64w.cu)
    names = sorted({src.split("/")[-1][:-len(".cu")]
                    for src, _ in KERNELS.values()} | {"gridpm64w"})
    with ThreadPoolExecutor(len(names)) as pool:
        infos = list(pool.map(cuda.build, names))
    for name, info in zip(names, infos):
        log("phase 2 build: %s.cu with nvcc %s in %.3f s"
            % (name, " ".join(cuda.NVCC_FLAGS), info["seconds"]))
        for kernel, line in ptxas_lines(info["log"]):
            log("  ptxas: %s: %s" % (kernel, line))


def ptxas_lines(build_log):
    """(kernel, line) for each line of ptxas's report in nvcc's
    ``build_log`` that gives a kernel's registers, stack frame or spills"""
    kernel = "?"
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            kernel = demangle(ln.split("'")[1])
        elif "registers" in ln or "spill" in ln or "stack" in ln:
            yield kernel, ln.strip()


def demangle(symbol):
    """a kernel's C++ name (c++filt, where the machine has it), without
    the anonymous namespace and the arguments"""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    out = out.replace("(anonymous namespace)::", "").split("(")[0]
    return out[len("void "):] if out.startswith("void ") else out or symbol


def lattice_cases(disp, meshes, bounds):
    """{case: (kernel record, fn(impl))} of the lattice kernels: the
    paint, the readouts of one mesh, with diffdir 0 and 'all', and of
    three meshes in one launch"""
    from pmesh_tpu_torch.ops import gridpm as gp
    return {
        "paint": ("paint_lattice",
                  lambda impl: (gp.paint_grid(disp, bounds=bounds,
                                              impl=impl),)),
        "readout 1 mesh": ("readout_lattice",
                           lambda impl: (gp.readout_grid(
                               meshes[0], disp, bounds, impl=impl),)),
        "readout diffdir=0": ("readout_lattice",
                              lambda impl: (gp.readout_grid(
                                  meshes[0], disp, bounds, diffdir=0,
                                  impl=impl),)),
        "readout diffdir='all'": ("readout_lattice",
                                  lambda impl: gp.readout_grid(
                                      meshes[0], disp, bounds,
                                      diffdir='all', impl=impl)),
        # the three meshes in one launch, as the spectral force reads them
        "readout 3 meshes": ("readout_lattice (3 meshes)",
                             lambda impl: gp.readout_grid(
                                 meshes, disp, bounds, impl=impl)),
    }


def phase_compare(dev):
    """kernel vs plain at N^3 for each of COMPARE_BOUNDS, then at the
    run-time width (WIDE_BOUNDS, WIDE_N^3); returns {kernel: record} at
    BOUNDS."""
    from pmesh_tpu_torch.ops import gridpm as gp
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    shape = (N,) * 3
    meshes = tuple(torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
    records = {}
    for bounds in COMPARE_BOUNDS:
        lo, hi = bounds
        disp = tuple(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                 device=dev)
                     for _ in range(3))
        vmin, vmax = gp.offset_range(lo, hi, 'cic')
        for name, (kernel, fn) in lattice_cases(disp, meshes,
                                                bounds).items():
            plain = fn('torch')
            got = fn('cuda')
            abs_err = max(float((g - p).abs().max())
                          for g, p in zip(got, plain))
            scale = max(float(p.abs().max()) for p in plain)
            rel = abs_err / scale
            ms = cuda_ms(lambda: fn('cuda'), 5)
            plain_ms = cuda_ms(lambda: fn('torch'), 1)
            ok = rel <= TOL_KERNEL and np.isfinite(rel)
            log("phase 3 compare: %-22s bounds=%-11s nv=%d  max|k-p|/max|p|"
                " = %.3e (tol %.0e) %s  kernel %.3f ms  plain %.3f ms"
                % (name, bounds, vmax - vmin + 1, rel, TOL_KERNEL,
                   "ok" if ok else "FAIL", ms, plain_ms))
            if not ok:
                raise AssertionError("%s disagrees with its plain version"
                                     % name)
            if bounds == BOUNDS and name in ("paint", "readout 1 mesh",
                                             "readout 3 meshes"):
                read = {"paint": disp, "readout 1 mesh": (disp, meshes[0]),
                        "readout 3 meshes": (disp, meshes)}[name]
                nv = vmax - vmin + 1
                ops = {"paint": paint_ops(nv, N ** 3),
                       "readout 1 mesh": readout_ops(nv, N ** 3),
                       "readout 3 meshes": readout_ops(nv, N ** 3, 3)}
                records[kernel] = record(
                    abs_err, ms, plain_ms, nbytes(read, plain), ops[name])
                log("phase 3 bound: %-22s %.3f ms by %s, kernel %.3f ms"
                    % (kernel, records[kernel]["bound_ms"],
                       records[kernel]["bound_by"], ms))
            elif kernel in records and bounds == BOUNDS:
                records[kernel]["max_abs_err"] = max(
                    records[kernel]["max_abs_err"], abs_err)
        del disp
    del meshes
    torch.cuda.empty_cache()
    # the kernels' run-time width (nv not compiled in), against plain
    shape = (WIDE_N,) * 3
    lo, hi = WIDE_BOUNDS
    meshes = tuple(torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
    disp = tuple(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                             device=dev) for _ in range(3))
    vmin, vmax = gp.offset_range(lo, hi, 'cic')
    for name, (kernel, fn) in lattice_cases(disp, meshes,
                                            WIDE_BOUNDS).items():
        rel = max_rel(fn('cuda'), fn('torch'))[0]
        ms = cuda_ms(lambda: fn('cuda'), 3)
        ok = rel <= TOL_KERNEL and np.isfinite(rel)
        log("phase 3 compare: %-22s %d^3 bounds=%s nv=%d (read at run "
            "time)  max|k-p|/max|p| = %.3e (tol %.0e) %s  kernel %.3f ms"
            % (name, WIDE_N, WIDE_BOUNDS, vmax - vmin + 1, rel, TOL_KERNEL,
               "ok" if ok else "FAIL", ms))
        if not ok:
            raise AssertionError("%s at nv=%d disagrees with its plain "
                                 "version" % (name, vmax - vmin + 1))
    del meshes, disp
    torch.cuda.empty_cache()
    return records


def phase_compare_lattice_bf16(dev):
    """the bf16 storage form of the lattice paint and readout (a bf16
    state and meshes; f32 weights and sums, each output rounded once, as
    the TPU kernels' _cdtype) at N^3: kernel vs plain by the bf16 storage
    criterion, the twin being the f32 kernel and plain on the same values
    upcast; then the form's run: one paint and one three-mesh readout of
    a bf16 state, the counters zeroed just before and read just after,
    the paint holding the mass to TOL_MASS.  A failed criterion goes to
    DEFERRED.  Returns ({kernel: record}, launches)"""
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import gridpm_cuda
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    shape, bf = (N,) * 3, torch.bfloat16
    lo, hi = BOUNDS
    disp = tuple((lo + (hi - lo) * torch.rand(shape, generator=gen,
                                              device=dev)).to(bf)
                 for _ in range(3))
    meshes = tuple(torch.randn(shape, generator=gen, device=dev).to(bf)
                   for _ in range(3))
    vmin, vmax = gp.offset_range(lo, hi, 'cic')
    nv = vmax - vmin + 1

    def up(ts):
        return tuple(t.float() for t in ts)

    def paint(impl, d, m):
        return (gp.paint_grid(d, bounds=BOUNDS, impl=impl),)

    def readout(impl, d, m):
        if impl == 'torch':
            return gp.readout_grid(m, d, BOUNDS, impl='torch')
        return gridpm_cuda.readout_lattice(m, d, vmin, vmax, 'cic')

    records = {}
    for kernel, fn, reads, ops in (
            ("paint_lattice_bf16", paint, (disp,), paint_ops(nv, N ** 3)),
            ("readout_lattice_bf16", readout, (disp, meshes),
             readout_ops(nv, N ** 3, len(meshes)))):
        got, plain = fn('cuda', disp, meshes), fn('torch', disp, meshes)
        got32 = fn('cuda', up(disp), up(meshes))
        plain32 = fn('torch', up(disp), up(meshes))
        ok, text = bf16_storage_check(got, plain, got32, plain32)
        err = max_rel(got, plain)[1]
        del got32, plain32
        ms = cuda_ms(lambda: fn('cuda', disp, meshes), 5)
        plain_ms = cuda_ms(lambda: fn('torch', disp, meshes), 1)
        rec = record(err, ms, plain_ms, nbytes(reads, got), ops)
        log("phase 3 compare: %-22s %d^3 bf16 %s %s  kernel %.3f ms  plain "
            "%.3f ms, bound %.3f ms by %s"
            % (kernel, N, text, "ok" if ok else "FAIL", ms, plain_ms,
               rec["bound_ms"], rec["bound_by"]))
        if not ok:
            DEFERRED.append("%s (%d^3 bf16)" % (kernel, N))
        records[kernel] = rec
        del got, plain
    gridpm_cuda.reset_launches()
    rho = gp.paint_grid(disp, bounds=BOUNDS)
    force = gridpm_cuda.readout_lattice(meshes, disp, vmin, vmax, 'cic')
    torch.cuda.synchronize()
    launches = dict(gridpm_cuda.LAUNCHES)
    mass_err = abs(float(rho.double().sum()) - N ** 3) / N ** 3
    finite = all(bool(torch.isfinite(f.float()).all()) for f in force)
    ok = (mass_err <= TOL_MASS and finite and launches["paint_lattice_bf16"]
          == 1 and launches["readout_lattice_bf16"] == 1)
    log("phase 3 bf16 lattice run: one paint and one three-mesh readout of "
        "a bf16 %d^3 state: mass error %.3e (tol %.0e), finite %s, launches "
        "%s %s" % (N, mass_err, TOL_MASS, finite,
                   json.dumps({k: v for k, v in launches.items() if v}),
                   "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the bf16 lattice run failed")
    del disp, meshes, rho, force
    torch.cuda.empty_cache()
    return records, launches


def run_path(pm, dlinear, steps, fft='xla'):
    from pmesh_tpu_torch.models.fastpm import Solver
    solver = Solver(pm)
    disp, vel = solver.lpt_lattice(dlinear, A0, order=2)
    S, V = solver.nbody_lattice(disp, vel, steps, BOUNDS, fft=fft)
    return solver, disp, vel, S, V


def max_rel(got, ref):
    """(max over outputs of max|got - ref| / max|ref|, max|got - ref|)"""
    rels, errs = [], []
    for g, r in zip(got, ref):
        err = float((g.float() - r.float()).abs().max())
        rels.append(err / float(r.float().abs().max()))
        errs.append(err)
    return max(rels), max(errs)


def as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def bf16_products_check(got, plain, plain32, tol=TOL_BF16):
    """the bf16 products' criterion over the outputs: max|k - p| within
    ``tol`` of max|p|, and the rms gap within TOL_CHAIN_RMS of the rms
    of the bf16 rounding itself (p against ``plain32``, the pass with
    f32 products); the share of the entries beyond TOL_BF16_NEAR of max
    is printed"""
    worst = share = ratio = rel = 0.0
    for g, p, f in zip(got, plain, plain32):
        d = (g.float() - p.float()).abs()
        scale = float(p.float().abs().max())
        effect = float(((p - f).double() ** 2).mean() ** 0.5)
        if effect == 0:
            # an output without products (the Nyquist row sum)
            rel = max(rel, float(d.max()) / scale)
            continue
        worst = max(worst, float(d.max()) / scale)
        share = max(share, float((d > TOL_BF16_NEAR * scale).float().mean()))
        ratio = max(ratio, float((d.double() ** 2).mean() ** 0.5) / effect)
    ok = worst <= tol and ratio <= TOL_CHAIN_RMS and rel <= TOL_KERNEL
    return ok, ("max|k-p|/max|p| = %.3e (tol %.0e), rms|k-p| / rms|p - f32|"
                " = %.3e (tol %.2f), %.2e of the entries beyond %.0e of max"
                % (worst, tol, ratio, TOL_CHAIN_RMS, share, TOL_BF16_NEAR))


def bf16_storage_check(got, plain, got32=None, plain32=None):
    """the bf16 storage criterion (see TOL_BF16) over the outputs; an
    f32 output (a real mesh, the Nyquist row sum) is held to
    TOL_KERNEL.  got32/plain32: the same pass with f32 outputs on the
    same values, whose kernel-plain gap is the gap of the f32 sums that
    each stored entry rounds"""
    neq, bad, rel = 0.0, 0, 0.0
    for k, (g, p) in enumerate(zip(got, plain)):
        if g.dtype != p.dtype:
            return False, "kernel %s, plain %s" % (g.dtype, p.dtype)
        if g.dtype != torch.bfloat16:
            rel = max(rel, max_rel((g,), (p,))[0])
            continue
        gf, pf = g.float(), p.float()
        m = torch.maximum(gf.abs(), pf.abs())
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.where(m > 0, m, torch.ones_like(m)))) - 7)
        gap = (got32[k] - plain32[k]).abs()
        neq = max(neq, float((gf != pf).float().mean()))
        bad += int(((gf - pf).abs() > ulp + gap).sum())
    ok = neq <= BF16_SHARE and bad == 0 and rel <= TOL_KERNEL
    return ok, ("bf16 outputs: %.2e of the entries not bitwise equal (at"
                " most %.0e), %d more than one ulp beyond their f32 gap;"
                " f32 outputs max|k-p|/max|p| = %.3e (tol %.0e)"
                % (neq, BF16_SHARE, bad, rel, TOL_KERNEL))


def bf16_once_check(got, plain, got32, plain32):
    """bf16 products stored in bf16 (the _bf16_bf16s combination): each
    bf16 output bitwise its kernel's f32-stored twin (``got32``, the same
    products) rounded once, and no entry more than one bf16 ulp from the
    plain version's beyond the gap of the two f32 outputs; an f32 output
    (the Nyquist row sum) within TOL_KERNEL"""
    once, bad, rel = True, 0, 0.0
    for k, (g, p) in enumerate(zip(got, plain)):
        if g.dtype != p.dtype:
            return False, "kernel %s, plain %s" % (g.dtype, p.dtype)
        if g.dtype != torch.bfloat16:
            rel = max(rel, max_rel((g,), (p,))[0])
            continue
        once = once and torch.equal(g, got32[k].to(torch.bfloat16))
        gf, pf = g.float(), p.float()
        m = torch.maximum(gf.abs(), pf.abs())
        ulp = torch.exp2(torch.floor(torch.log2(
            torch.where(m > 0, m, torch.ones_like(m)))) - 7)
        bad += int(((gf - pf).abs()
                    > ulp + (got32[k] - plain32[k]).abs()).sum())
    ok = once and bad == 0 and rel <= TOL_KERNEL
    return ok, ("bf16 outputs: the f32-stored products rounded once %s, %d "
                "entries more than one ulp beyond their f32 gap; f32 "
                "outputs max|k-p|/max|p| = %.3e (tol %.0e)"
                % (once, bad, rel, TOL_KERNEL))


def fft_ops(n, count, real=False):
    """operations of ``count`` FFTs of length n by the usual count:
    5 n log2 n for a complex transform, half that for a real one"""
    return count * (2.5 if real else 5.0) * n * np.log2(n)


def zy_ops(n0, N1, n2):
    """a zy pass of n0 planes (N1, n2): real FFTs of length n2 along z,
    complex FFTs of length N1 along y over the n2 // 2 + 1 columns"""
    return fft_ops(n2, n0 * N1, real=True) + fft_ops(N1, n0 * (n2 // 2 + 1))


def f64_products(fn):
    """fn('torch') with every product of the plain passes summed in f64
    (the f32 operands' exact products, each pass's output rounded once
    to its storage): the checks' reference for how far kernel and plain
    version each sit from exact products"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    orig = fm._mm
    fm._mm = lambda a, b, bf16=False: torch.matmul(a.double(), b.double())
    try:
        return fn('torch')
    finally:
        fm._mm = orig


def dft_case(records, kernel, label, fn, reads, ops, library=None,
             check=None, failed=None, exact=False):
    """one DFT pass, kernel vs plain: fn(impl) gives its output(s),
    ``reads`` are the tensors and tables it reads, ``ops`` the
    operations of the FFTs computing the same transform, ``library`` a call of torch.fft computing the same
    function (timed where given).  A bf16 form gives ``check`` =
    (criterion, fn32): criterion(got, plain, *twin) -> (ok, text), twin
    the outputs of fn32(impl) for the plain version (products) or for
    both (storage), the same pass in f32; the default is TOL_KERNEL.
    Every case logs its bound; the first case of each kernel is its
    record, later cases add to its error.  A failing case raises, or
    is appended to ``failed`` when given.  ``exact``: also hold the
    kernel's gap to f64 products (``f64_products``) to at most the plain
    version's.  Returns the kernel's output."""
    plain = fn('torch')
    got = fn('cuda')
    rel, err = max_rel(as_tuple(got), as_tuple(plain))
    if check is None:
        ok = rel <= TOL_KERNEL and np.isfinite(rel)
        text = "max|k-p|/max|p| = %.3e (tol %.0e)" % (rel, TOL_KERNEL)
        if exact:
            ref = as_tuple(f64_products(fn))
            rel_k = max_rel(as_tuple(got), ref)[0]
            rel_p = max_rel(as_tuple(plain), ref)[0]
            del ref
            ok = ok and rel_k <= rel_p
            text += (", against f64 products kernel %.3e, plain %.3e "
                     "(kernel at most plain)" % (rel_k, rel_p))
    else:
        criterion, fn32 = check
        twin = ()
        if fn32 is not None:
            twin = (as_tuple(fn32('torch')),)
            if criterion in (bf16_storage_check, bf16_once_check):
                # both twins
                twin = (as_tuple(fn32('cuda')),) + twin
        ok, text = criterion(as_tuple(got), as_tuple(plain), *twin)
        ok = ok and np.isfinite(rel)
    del plain
    ms = cuda_ms(lambda: fn('cuda'), 5)
    plain_ms = cuda_ms(lambda: fn('torch'), 1)
    log("phase 3 compare: %-16s %-36s %s %s  kernel %.3f ms  plain %.3f ms"
        % (kernel, label, text, "ok" if ok else "FAIL", ms, plain_ms))
    if not ok:
        if failed is None:
            raise AssertionError("%s disagrees with its plain version (%s)"
                                 % (kernel, label))
        failed.append("%s (%s)" % (kernel, label))
    lib_ms = None if library is None else cuda_ms(library, 5)
    rec = record(err, ms, plain_ms, nbytes(reads, got), ops, lib_ms)
    log("phase 3 bound: %-16s %-36s %.3f ms by %s, kernel %.3f ms, "
        "library call %s ms" % (kernel, label, rec["bound_ms"],
                                rec["bound_by"], ms,
                                "none" if lib_ms is None else "%.3f" % lib_ms))
    if kernel in records:
        records[kernel]["max_abs_err"] = max(records[kernel]["max_abs_err"],
                                             err)
    else:
        records[kernel] = rec
    return got


def library_inverse(rr, ii, n2, copies=1):
    """torch.fft's yardstick of a zy inverse: the unnormalized irfft
    over y and z of ``copies`` stacked copies of the complex spectrum"""
    z = torch.complex(rr, ii)
    if copies > 1:
        z = torch.stack([z] * copies)
    n1 = rr.shape[1]
    return lambda: torch.fft.irfftn(z, s=(n1, n2), dim=(-2, -1),
                                    norm='forward')


def library_dual_x(rr, ii, k2=None):
    """torch.fft's yardstick of a dual inverse x pass: the ifft along x
    of two stacked copies of the spectrum, with 1/k^2 (DC zeroed) from
    the three 1-d tables ``k2`` folded in beforehand when given"""
    z = torch.complex(rr.float(), ii.float())
    if k2 is not None:
        kk = sum(torch.as_tensor(np.asarray(t, np.float32), device=z.device)
                 .reshape([-1 if e == d else 1 for e in range(3)])
                 for d, t in enumerate(k2))
        z = z * torch.where(kk > 0, 1.0 / torch.where(kk > 0, kk, 1.0), 0.0)
    z = torch.stack([z, z])
    return lambda: torch.fft.ifft(z, dim=1)


def tc_share(label, fma, ms, products=6):
    """the tensor-core rate of a pass of the split-precision routine:
    ``fma`` real multiply-adds of its block products, six bf16 products
    each (2 FLOP apiece; one in the bf16 form; a mean where the stages
    differ), over ``ms``, against the bf16 peak (the same share as three
    TF32 products against 495 TFLOP/s)"""
    rate = products * 2 * fma / (ms * 1e-3)
    log("phase 3 tensor cores: %-40s %.3f G real FMA x %.3g bf16 products in "
        "%.3f ms: %.1f TFLOP/s, %.3f of %.0f TFLOP/s (%s)"
        % (label, fma / 1e9, products, ms, rate / 1e12, rate / PEAK_BF16,
           PEAK_BF16 / 1e12, CARD))
    return rate / PEAK_BF16


def dense_zy_fma(n0, N1, N2):
    """real FMA of zy_fwd_half's products: the z stage's real rows times
    the (N2, Zh) pair (2 per row, k and mode), the y stage's complex
    (N1 x N1) products over the Zh columns (4 each)"""
    Zh = N2 // 2 + 1
    return 2.0 * n0 * N1 * N2 * Zh + 4.0 * n0 * N1 * N1 * Zh


def dense_x_fma(N0, ncols, sets=1):
    """real FMA of an x_dense pass: complex (N0 x N0) products over the
    columns, per table set"""
    return 4.0 * sets * N0 * N0 * ncols


def zy_inv_full_fma(n0, N1, N2):
    """real FMA of zy_inv_full's products: the z stage's [xr | xi] rows
    times the stacked (2 N2 x 2 N2) table, the y stage's real output
    (N1 rows [Wr | -Wi], 2 N1 long) over the n0 N2 columns"""
    return 4.0 * n0 * N1 * N2 * N2 + 2.0 * n0 * N1 * N1 * N2


def zy_fwd_half_ct_fma(n0, N1, N2):
    """real FMA of zy_fwd_half_ct's products: the z stage's real rows
    times the (N2, Zh) pair (2 per row, k and mode), the y CT's Ry
    chunks of (2 My x 2 My) over the n0 Zh columns"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    Ry, My = fm._ct_factor(N1)
    Zh = N2 // 2 + 1
    return 2.0 * n0 * N1 * N2 * Zh + 4.0 * n0 * Zh * Ry * My * My


def row13_tensor_cores(label, fma, call):
    """a row-13 zy pass's tensor-core share in both forms (six products
    per real FMA, one), and its device launches (tc_check)"""
    for prec, products in ((None, 6), ('bf16', 1)):
        name = "%s %s" % (label, prec or 'f32')
        tc_share(name, fma, cuda_ms(lambda: call(prec), 5), products)
        tc_check(name, lambda: call(prec))


def tc_check(label, fn):
    """an entry point that runs its products on tc_gemm (the dense
    passes, the zy inverses, the bf16 forward ct2 passes, row 13's zy
    passes): the kernels that one fn() call launches, counted by the C
    entry points where each is launched, include tc_gemm and the split
    passes and no kind but TC_KINDS; raises otherwise"""
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    fft_mxu_cuda.kernel_launches(reset=True)
    fn()
    torch.cuda.synchronize()
    ks = fft_mxu_cuda.kernel_launches(reset=True)
    off = off_tensor_cores(ks)
    ok = ks["tc_gemm"] >= 1 and ks["split"] >= 1 and not off
    log("phase 3 kernel launches: %-46s tc_gemm %d, split passes %d, "
        "ct_fwd_col0 %d, other kinds %s %s"
        % (label, ks["tc_gemm"], ks["split"], ks["ct_fwd_col0"],
           off or "none", "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("%s did not run on tc_gemm alone" % label)


def zy_inv_fma(n0, N1, n2, sets=1, y_weight=1.0):
    """real FMA of the products of zy_inv_ct2 (per table set): the y CT's
    (2M x 2M) per column (times y_weight), the z stage's real rows, 2 Zm
    contraction values per output (the z-CT: 2 Kin per P and Q output of
    each of its Ri chunks, 2 Kb of them)"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    Ry, My = fm._ct_factor(N1)
    Zm = n2 // 2
    width = n2
    if fm._use_zct_inv(n2, Zm):
        Ri, Kin, Kb = np.shape(fm._cached(fm._z_inv_tabs, n2, Zm)[0])
        width = 2 * Kb
    return sets * (y_weight * 4.0 * n0 * Ry * My * My * Zm
                   + 2.0 * n0 * N1 * Zm * width)


def zy_fma(n0, N1, N2):
    """real FMA of the block products of zy_fwd_ct2: the z stage's
    (2K x 2Mq) per row and chunk, the y CT's (2M x 2M) per column"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    Rz, K, Mq = fm._zct_factor(N2)
    Ry, My = fm._ct_factor(N1)
    return 4.0 * n0 * N1 * Rz * K * Mq + 4.0 * n0 * Ry * My * My * (N2 // 2)


def zy_bf16_fma(n0, N1, N2):
    """real FMA of zy_fwd_ct2's bf16-product form on tc_gemm: the z-CT
    stage's chunks (K real data columns for u_0 and u_{Rz/2}, 2K for the
    others, times 2 Mq), or the dense z stage's real rows (N2 x 2 Zm);
    the y CT's (2M x 2M) per column"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    Rz, K, Mq = fm._zct_factor(N2)
    Ry, My = fm._ct_factor(N1)
    order = fm._zct_order(Rz)
    kz = (sum(K if j in (0, Rz // 2) else 2 * K for j in order) * 2 * Mq
          if Rz > 1 else N2 * N2)
    return n0 * N1 * kz + 4.0 * n0 * Ry * My * My * (N2 // 2)


def x_fma(N0, ncols, sets=1):
    """real FMA of the block products of an x CT pass of xct_multi"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    R, M = fm._ct_factor(N0)
    return 4.0 * sets * R * M * M * ncols


def fft_yardsticks(rho, kd, k2, label):
    """torch.fft's yardsticks of one spectral force's FFT work on the
    real mesh ``rho``: rfftn(x, norm='forward') for the forward rows,
    then the filter i k_d / k^2 (DC zeroed) on the stacked spectrum and
    the stacked irfftn of the three filtered spectra for the force
    triple, each timed alone"""
    shape = tuple(rho.shape)
    dev = rho.device
    spec = torch.fft.rfftn(rho, norm='forward')
    k2t = [torch.tensor(k, dtype=torch.float32, device=dev) for k in k2]
    kk = k2t[0][:, None, None] + k2t[1][None, :, None] + k2t[2][None, None]
    invk2 = torch.where(kk > 0, 1.0 / torch.where(kk > 0, kk, 1.0), 0.0)
    filt = []
    for d in range(3):
        kd_d = torch.tensor(kd[d], dtype=torch.float32, device=dev)
        kd_d = kd_d.reshape([-1 if e == d else 1 for e in range(3)])
        filt.append(torch.complex(torch.zeros_like(invk2), kd_d * invk2))
    filt = torch.stack(filt)
    del kk, invk2
    fwd_ms = cuda_ms(lambda: torch.fft.rfftn(rho, norm='forward'), 5)
    filt_ms = cuda_ms(lambda: spec[None] * filt, 5)
    stacked = spec[None] * filt
    inv_ms = cuda_ms(lambda: torch.fft.irfftn(stacked, s=shape,
                                              dim=(1, 2, 3),
                                              norm='forward'), 5)
    log("phase 3 yardsticks: %s %s rfftn(norm='forward') %.3f ms, filter "
        "i k_d / k^2 on the stacked spectrum %.3f ms, stacked irfftn of "
        "three spectra %.3f ms" % (label, shape, fwd_ms, filt_ms, inv_ms))
    del spec, filt, stacked
    torch.cuda.empty_cache()


def phase_compare_fft(dev):
    """the four DFT passes of fft='mxu', kernel vs plain, at N^3 (the
    main path's forms) and on the MXU_SLAB (the z-CT inverse); returns
    {kernel: record} of each kernel's first N^3 case"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import gridpm as gp
    records = {}

    def case(label, kernel, fn, reads, ops, library=None, exact=False):
        return dft_case(records, kernel, label, fn, reads, ops, library,
                        exact=exact)

    # the N^3 density of a lattice paint, and the solver's tables
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    shape = (N,) * 3
    disp = tuple(BOUNDS[0] + (BOUNDS[1] - BOUNDS[0])
                 * torch.rand(shape, generator=gen, device=dev)
                 for _ in range(3))
    rho = gp.paint_grid(disp, bounds=BOUNDS)
    del disp
    pm = ParticleMesh([N] * 3, BoxSize=BOX, dtype='f4', device=dev)
    _, pk2, kd, _ = Solver(pm)._mxu_setup()
    Zm = N // 2
    # x and y are both N long: one forward and one inverse CT table
    wz = fm._cached(fm._z_fwd_tabs, N, Zm)
    wf, wi = fm._cached(fm._ct_fwd_mats_np, N), fm._cached(
        fm._ct_inv_mats_np, N)
    wx_g = fm._cached(fm._ct_inv_mats_np, N, kd[0])
    wy_g = fm._cached(fm._ct_inv_mats_np, N, kd[1])
    AB_p = fm._cached(fm._z_inv_tabs, N, Zm)
    AB_g = fm._cached(fm._z_inv_tabs, N, Zm, kd[2])
    _, k2m = fm._cached(fm._poisson_tables, pk2, N, N, Zm)
    pr, pi, nq = case("%d^3 density" % N, "zy_fwd_ct2",
                      lambda impl: fm._zy_fwd_ct2_call(rho, N, Zm, wz, wf,
                                                       impl=impl),
                      (rho, wz, wf), zy_ops(N, N, N),
                      lambda: torch.fft.rfftn(rho, dim=(1, 2)), exact=True)
    tc_share("zy_fwd_ct2 %d^3" % N, zy_fma(N, N, N),
             cuda_ms(lambda: fm._zy_fwd_ct2_call(rho, N, Zm, wz, wf), 5))
    fft_yardsticks(rho, kd, pk2, "ct2")
    del rho
    zc = torch.complex(pr, pi)
    r, i = case("forward x 1/N^3", "xct_multi",
                lambda impl: fm._xct_call_multi(
                    pr, pi, wf, 1.0 / N ** 3, impl=impl),
                (pr, pi, wf), fft_ops(N, N * Zm),
                lambda: torch.fft.fft(zc, dim=0), exact=True)
    tc_share("xct_multi forward %d^3" % N, x_fma(N, N * Zm),
             cuda_ms(lambda: fm._xct_call_multi(pr, pi, wf, 1.0 / N ** 3), 5))
    del pr, pi, zc
    sr, si, gr, gi = case("inverse dual (kx-folded), 1/k^2", "xct_multi",
                          lambda impl: fm._xct_call_multi(
                              r, i, wi, 1.0, inverse=True, wx2=wx_g, k2=k2m,
                              impl=impl),
                          (r, i, wi, wx_g, k2m), 2 * fft_ops(N, N * Zm),
                          library_dual_x(r, i, k2m), exact=True)
    tc_share("xct_multi dual inverse %d^3 (sweeps included)" % N,
             x_fma(N, N * Zm, 2),
             cuda_ms(lambda: fm._xct_call_multi(r, i, wi, 1.0, inverse=True,
                                                wx2=wx_g, k2=k2m), 5))
    del r, i
    plane = nq / N ** 3
    case("fx: plane", "zy_inv_ct2",
         lambda impl: fm._zy_inv_ct2_call(gr, gi, wi, AB_p, N, plane=plane,
                                          impl=impl),
         (gr, gi, wi, AB_p, plane), zy_ops(N, N, N),
         library_inverse(gr, gi, N))
    case("fz: no plane, z-folded dense z", "zy_inv_ct2",
         lambda impl: fm._zy_inv_ct2_call(sr, si, wi, AB_g, N, impl=impl),
         (sr, si, wi, AB_g), zy_ops(N, N, N))
    case("(fy, fz), plane on A", "zy_inv_ct2_dual",
         lambda impl: fm._zy_inv_ct2_call_dual(sr, si, wy_g, AB_p, wi, AB_g,
                                               N, planeA=plane, impl=impl),
         (sr, si, wy_g, AB_p, wi, AB_g, plane),
         2 * zy_ops(N, N, N), library_inverse(sr, si, N, copies=2))
    for sets, label, call in (
            (1, "zy_inv_ct2", lambda: fm._zy_inv_ct2_call(
                gr, gi, wi, AB_p, N, plane=plane)),
            (2, "zy_inv_ct2_dual", lambda: fm._zy_inv_ct2_call_dual(
                sr, si, wy_g, AB_p, wi, AB_g, N, planeA=plane))):
        tc_share("%s %d^3" % (label, N), zy_inv_fma(N, N, N, sets),
                 cuda_ms(call, 5))
        tc_check("%s %d^3 f32" % (label, N), call)
    del sr, si, gr, gi, nq, plane
    torch.cuda.empty_cache()

    # the slab: z = 1024 takes the fused z-CT inverse
    _, N1, n2 = MXU_SLAB
    Zs = n2 // 2
    x = 1.0 + 0.3 * torch.randn(MXU_SLAB, generator=gen, device=dev)
    AB_s = fm._cached(fm._z_inv_tabs, n2, Zs)
    AB_sg = fm._cached(fm._z_inv_tabs, n2, Zs,
                       tuple(float(v) for v in np.sin(
                           np.fft.rfftfreq(n2) * 2 * np.pi)))
    assert np.ndim(AB_s[0]) == 3
    wys, wyis = fm._cached(fm._ct_fwd_mats_np, N1), fm._cached(
        fm._ct_inv_mats_np, N1)
    wzs = fm._cached(fm._z_fwd_tabs, n2, Zs)
    pr, pi, nq = case("slab %s" % (MXU_SLAB,), "zy_fwd_ct2",
                      lambda impl: fm._zy_fwd_ct2_call(
                          x, n2, Zs, wzs, wys, impl=impl),
                      (x, wzs, wys), zy_ops(*MXU_SLAB),
                      lambda: torch.fft.rfftn(x, dim=(1, 2)), exact=True)
    tc_share("zy_fwd_ct2 slab %s" % (MXU_SLAB,), zy_fma(*MXU_SLAB),
             cuda_ms(lambda: fm._zy_fwd_ct2_call(x, n2, Zs, wzs, wys), 5))
    case("slab, z-CT inverse, plane", "zy_inv_ct2",
         lambda impl: fm._zy_inv_ct2_call(pr, pi, wyis, AB_s, n2, plane=nq,
                                          impl=impl),
         (pr, pi, wyis, AB_s, nq), zy_ops(*MXU_SLAB))
    case("slab, z-CT inverse, plane on A", "zy_inv_ct2_dual",
         lambda impl: fm._zy_inv_ct2_call_dual(pr, pi, wyis, AB_s, wyis,
                                               AB_sg, n2, planeA=nq,
                                               impl=impl),
         (pr, pi, wyis, AB_s, AB_sg, nq), 2 * zy_ops(*MXU_SLAB))
    tc_share("zy_inv_ct2 slab %s (z-CT)" % (MXU_SLAB,),
             zy_inv_fma(*MXU_SLAB),
             cuda_ms(lambda: fm._zy_inv_ct2_call(pr, pi, wyis, AB_s, n2,
                                                 plane=nq), 5))
    tc_check("zy_inv_ct2 slab %s (z-CT) f32" % (MXU_SLAB,),
             lambda: fm._zy_inv_ct2_call(pr, pi, wyis, AB_s, n2, plane=nq))
    del x, pr, pi, nq
    torch.cuda.empty_cache()
    return records


def phase_compare_dense(dev):
    """the three dense DFT passes (fft='mxu' at shapes that are not
    ct2), kernel vs plain, on a lattice paint's NC^3 density (the
    clustered run's shape: the records) and on a ragged DENSE_RAGGED
    mesh; returns {kernel: record}"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import gridpm as gp
    records = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for shape in ((NC,) * 3, DENSE_RAGGED):
        N0, N1, n2 = shape
        Zh = n2 // 2 + 1
        if shape == (NC,) * 3:
            disp = tuple(BOUNDS[0] + (BOUNDS[1] - BOUNDS[0])
                         * torch.rand(shape, generator=gen, device=dev)
                         for _ in range(3))
            x = gp.paint_grid(disp, bounds=BOUNDS)
            del disp
        else:
            x = 1.0 + 0.3 * torch.randn(shape, generator=gen, device=dev)
        pm = ParticleMesh(list(shape), BoxSize=np.asarray(shape, float),
                          dtype='f4', device=dev)
        _, pk2, kd, ct = Solver(pm)._mxu_setup()
        assert not ct
        kd = fm._tuples(kd)
        wz = fm._cached(fm._dft_half_np, n2, Zh)
        wyf, wxf = fm._cached(fm._dft_np, N1, -1), fm._cached(fm._dft_np,
                                                              N0, -1)
        wy, wx = fm._cached(fm._dft_np, N1, +1), fm._cached(fm._dft_np,
                                                            N0, +1)
        wx_g = fm._cached(fm._dft_fold_np, N0, kd[0])
        wy_g = fm._cached(fm._dft_fold_np, N1, kd[1])
        AB_p = fm._cached(fm._irfft_mats_np, n2, Zh)
        AB_g = fm._cached(fm._irfft_mats_np, n2, Zh, kd[2])
        k2 = fm._cached(fm._dense_k2_tables, fm._tuples(pk2), N0, N1, Zh)
        ops_x = fft_ops(N0, N1 * Zh)
        ops_zy = zy_ops(N0, N1, n2)

        def case(label, kernel, fn, reads, ops, library=None, exact=False):
            return dft_case(records, kernel, "%s %s" % (shape, label), fn,
                            reads, ops, library, exact=exact)

        def tensor_cores(label, fma, call):
            """the pass's tensor-core share in both forms, and its device
            launches: tc_gemm and its split passes"""
            for prec, products in ((None, 6), ('bf16', 1)):
                tc_share("%s %s %s" % (label, shape, prec or 'f32'), fma,
                         cuda_ms(lambda: call(prec), 5), products)
                tc_check("%s %s %s" % (label, shape, prec or 'f32'),
                         lambda: call(prec))
        pr, pi = case("density", "zy_fwd_half",
                      lambda impl: fm._zy_fwd_dense_call(x, wz, wyf,
                                                         impl=impl),
                      (x, wz, wyf), ops_zy,
                      lambda: torch.fft.rfftn(x, dim=(1, 2)), exact=True)
        tensor_cores("zy_fwd_half", dense_zy_fma(N0, N1, n2),
                     lambda prec: fm._zy_fwd_dense_call(x, wz, wyf,
                                                        precision=prec))
        if shape == (NC,) * 3:
            fft_yardsticks(x, kd, pk2, "dense")
        del x
        zc = torch.complex(pr, pi)
        r, i = case("forward x 1/N^3", "x_dense",
                    lambda impl: fm._x_dense_call(pr, pi, wxf,
                                                  1.0 / (N0 * N1 * n2),
                                                  impl=impl),
                    (pr, pi, wxf), ops_x, lambda: torch.fft.fft(zc, dim=0),
                    exact=True)
        tensor_cores("x_dense forward", dense_x_fma(N0, N1 * Zh),
                     lambda prec: fm._x_dense_call(
                         pr, pi, wxf, 1.0 / (N0 * N1 * n2), precision=prec))
        del pr, pi, zc
        sr, si, gr, gi = case("inverse dual (kx-folded), 1/k^2", "x_dense",
                              lambda impl: fm._x_dense_call(
                                  r, i, wx, 1.0, wx2=wx_g, k2=k2,
                                  impl=impl),
                              (r, i, wx, wx_g, k2), 2 * ops_x,
                              library_dual_x(r, i, k2), exact=True)
        tensor_cores("x_dense dual inverse", dense_x_fma(N0, N1 * Zh, 2),
                     lambda prec: fm._x_dense_call(
                         r, i, wx, 1.0, wx2=wx_g, k2=k2, precision=prec))
        del r, i
        case("fx tables", "zy_inv_half",
             lambda impl: fm._zy_inv_dense_call(gr, gi, wy, AB_p, impl=impl),
             (gr, gi, wy, AB_p), ops_zy, library_inverse(gr, gi, n2))
        case("fy tables", "zy_inv_half",
             lambda impl: fm._zy_inv_dense_call(sr, si, wy_g, AB_p,
                                                impl=impl),
             (sr, si, wy_g, AB_p), ops_zy, library_inverse(sr, si, n2))
        case("fz tables", "zy_inv_half",
             lambda impl: fm._zy_inv_dense_call(sr, si, wy, AB_g, impl=impl),
             (sr, si, wy, AB_g), ops_zy, library_inverse(sr, si, n2))
        # the inverse's products: the same count as the forward's
        tensor_cores("zy_inv_half", dense_zy_fma(N0, N1, n2),
                     lambda prec: fm._zy_inv_dense_call(gr, gi, wy, AB_p,
                                                        precision=prec))
        del sr, si, gr, gi
        torch.cuda.empty_cache()
    return records


def zy_full_ops(n0, N1, n2):
    """a full-spectrum zy pass of n0 planes (N1, n2): real FFTs of
    length n2 along z, complex FFTs of length N1 along y over all n2
    columns"""
    return fft_ops(n2, n0 * N1, real=True) + fft_ops(N1, n0 * n2)


def super_lanczos(n, cell=1.0, half=False):
    """the SuperLanczos difference kernel k_d over fftfreq (rfftfreq
    when ``half``) of a length-n axis, as a tuple; zero at Nyquist"""
    k = (np.fft.rfftfreq(n, d=cell) if half
         else np.fft.fftfreq(n, d=cell)) * 2 * np.pi
    w = k * cell
    return tuple((1.0 / (6.0 * cell) * (8 * np.sin(w) - np.sin(2 * w)))
                 .tolist())


def full_yardsticks(x, kd):
    """torch.fft's yardsticks of the full-spectrum pipeline on the real
    mesh ``x``: fftn(x, norm='forward'), the filter i k_d / k^2 (DC
    zeroed, k_d = ``kd``, k^2 over fftfreq) on the stacked full
    spectrum, and the real part of the stacked ifftn, each timed alone"""
    shape, dev = tuple(x.shape), x.device
    spec = torch.fft.fftn(x, norm='forward')
    ks = [torch.tensor(np.fft.fftfreq(n) * 2 * np.pi, dtype=torch.float32,
                       device=dev) for n in shape]
    kk = (ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
          + ks[2][None, None] ** 2)
    invk2 = torch.where(kk > 0, 1.0 / torch.where(kk > 0, kk, 1.0), 0.0)
    filt = []
    for d in range(3):
        kd_d = torch.tensor(kd[d], dtype=torch.float32, device=dev)
        kd_d = kd_d.reshape([-1 if e == d else 1 for e in range(3)])
        filt.append(torch.complex(torch.zeros_like(invk2), kd_d * invk2))
    filt = torch.stack(filt)
    del kk, invk2
    fwd_ms = cuda_ms(lambda: torch.fft.fftn(x, norm='forward'), 5)
    filt_ms = cuda_ms(lambda: spec[None] * filt, 5)
    stacked = spec[None] * filt
    inv_ms = cuda_ms(lambda: torch.fft.ifftn(stacked, dim=(1, 2, 3),
                                             norm='forward').real, 5)
    log("phase 3 yardsticks: full spectrum %s fftn(norm='forward') %.3f ms,"
        " filter i k_d / k^2 on the stacked spectrum %.3f ms, real part of "
        "the stacked ifftn of three spectra %.3f ms"
        % (shape, fwd_ms, filt_ms, inv_ms))
    del spec, filt, stacked
    torch.cuda.empty_cache()


def phase_compare_ref(dev):
    """the row-13 passes (fft_mxu_ref.py), kernel vs plain: the
    full-spectrum pipeline on a lattice paint's N^3 density (the
    records) and on a ragged REF_SMALL mesh, the first-CT half pipeline
    on the N^3 density (R = 4, Zh = N/2 + 1) and on CT_RAGGED; returns
    {kernel: record}"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    from pmesh_tpu_torch.ops import gridpm as gp
    records = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    disp = tuple(BOUNDS[0] + (BOUNDS[1] - BOUNDS[0])
                 * torch.rand((N,) * 3, generator=gen, device=dev)
                 for _ in range(3))
    rho = gp.paint_grid(disp, bounds=BOUNDS)
    del disp

    def mesh(shape):
        if shape == (N,) * 3:
            return rho
        return 1.0 + 0.3 * torch.randn(shape, generator=gen, device=dev)

    for shape in ((N,) * 3, REF_SMALL):
        N0, N1, n2 = shape
        x = mesh(shape)
        kv = tuple(super_lanczos(n) for n in shape)
        wz, wy, wx = (fm._cached(fm._dft_np, n, -1) for n in (n2, N1, N0))
        wyi, wxi = (fm._cached(fm._dft_np, n, +1) for n in (N1, N0))
        wx_g = fm._cached(fm._dft_fold_np, N0, kv[0])
        wy_g = fm._cached(fm._dft_fold_np, N1, kv[1])
        AB = fm._cached(ref._z_inv_full_np, n2, None)
        AB_g = fm._cached(ref._z_inv_full_np, n2, kv[2])
        ops_zy, ops_x = zy_full_ops(N0, N1, n2), fft_ops(N0, N1 * n2)

        def case(label, kernel, fn, reads, ops, library=None):
            return dft_case(records, kernel, "%s %s" % (shape, label), fn,
                            reads, ops, library)
        pr, pi = case("density", "zy_fwd_full",
                      lambda impl: ref._zy_fwd_full_call(x, wz, wy, impl=impl),
                      (x, wz, wy), ops_zy,
                      lambda: torch.fft.fftn(x, dim=(1, 2)))
        for prec in (None, 'bf16'):
            tc_check("zy_fwd_full %s %s" % (shape, prec or 'f32'),
                     lambda: ref._zy_fwd_full_call(x, wz, wy,
                                                   precision=prec))
            tc_check("x_dense (full spectrum) %s %s"
                     % (shape, prec or 'f32'),
                     lambda: fm._x_dense_call(pr, pi, wxi, 1.0,
                                              wx2=wx_g, precision=prec))
        if shape == (N,) * 3:
            full_yardsticks(x, kv)
        del x
        zc = torch.complex(pr, pi)
        r, i = case("forward x 1/N^3", "x_dense (full spectrum)",
                    lambda impl: fm._x_dense_call(pr, pi, wx,
                                                  1.0 / (N0 * N1 * n2),
                                                  impl=impl),
                    (pr, pi, wx), ops_x, lambda: torch.fft.fft(zc, dim=0))
        del pr, pi, zc
        sr, si, gr, gi = case("inverse dual (kx-folded)",
                              "x_dense (full spectrum)",
                              lambda impl: fm._x_dense_call(
                                  r, i, wxi, 1.0, wx2=wx_g, impl=impl),
                              (r, i, wxi, wx_g), 2 * ops_x,
                              library_dual_x(r, i))
        del r, i
        zc = torch.complex(gr, gi)
        case("fx tables", "zy_inv_full",
             lambda impl: ref._zy_inv_full_call(gr, gi, wyi, AB, impl=impl),
             (gr, gi, wyi, AB), ops_zy,
             lambda: torch.fft.ifftn(zc, dim=(1, 2), norm='forward').real)
        del zc
        case("fy tables", "zy_inv_full",
             lambda impl: ref._zy_inv_full_call(sr, si, wy_g, AB, impl=impl),
             (sr, si, wy_g, AB), ops_zy)
        case("fz tables (z-folded rows)", "zy_inv_full",
             lambda impl: ref._zy_inv_full_call(sr, si, wyi, AB_g, impl=impl),
             (sr, si, wyi, AB_g), ops_zy)
        row13_tensor_cores("zy_inv_full %s" % (shape,),
                           zy_inv_full_fma(N0, N1, n2),
                           lambda prec: ref._zy_inv_full_call(
                               sr, si, wyi, AB_g, precision=prec))
        del sr, si, gr, gi
        torch.cuda.empty_cache()

    for shape in ((N,) * 3, CT_RAGGED):
        N0, N1, n2 = shape
        Zh = n2 // 2 + 1
        x = mesh(shape)
        kd = (super_lanczos(N0), super_lanczos(N1),
              super_lanczos(n2, half=True))
        wz = fm._cached(fm._dft_half_np, n2, Zh)
        wy, wx = (fm._cached(fm._ct_fwd_mats_np, n) for n in (N1, N0))
        wyi, wxi = (fm._cached(fm._ct_inv_mats_np, n) for n in (N1, N0))
        wx_g = fm._cached(fm._ct_inv_mats_np, N0, kd[0])
        wy_g = fm._cached(fm._ct_inv_mats_np, N1, kd[1])
        AB_p = fm._cached(fm._irfft_mats_np, n2, Zh)
        AB_g = fm._cached(fm._irfft_mats_np, n2, Zh, kd[2])
        ops_zy, ops_x = zy_ops(N0, N1, n2), fft_ops(N0, N1 * Zh)

        def case(label, kernel, fn, reads, ops, library=None):
            return dft_case(records, kernel, "%s %s" % (shape, label), fn,
                            reads, ops, library)
        pr, pi = case("density", "zy_fwd_half_ct",
                      lambda impl: ref._zy_fwd_half_ct_call(x, wz, wy, impl=impl),
                      (x, wz, wy), ops_zy,
                      lambda: torch.fft.rfftn(x, dim=(1, 2)))
        row13_tensor_cores("zy_fwd_half_ct %s" % (shape,),
                           zy_fwd_half_ct_fma(N0, N1, n2),
                           lambda prec: ref._zy_fwd_half_ct_call(
                               x, wz, wy, precision=prec))
        del x
        zc = torch.complex(pr, pi)
        r, i = case("forward x 1/N^3", "xct_multi (half CT)",
                    lambda impl: fm._xct_call_multi(
                        pr, pi, wx, 1.0 / (N0 * N1 * n2), impl=impl),
                    (pr, pi, wx), ops_x, lambda: torch.fft.fft(zc, dim=0))
        del pr, pi, zc
        sr, si, gr, gi = case("inverse dual (kx-folded)",
                              "xct_multi (half CT)",
                              lambda impl: fm._xct_call_multi(
                                  r, i, wxi, 1.0, inverse=True, wx2=wx_g,
                                  impl=impl),
                              (r, i, wxi, wx_g), 2 * ops_x,
                              library_dual_x(r, i))
        del r, i
        case("fx tables", "zy_inv_half_ct",
             lambda impl: ref._zy_inv_half_ct_call(gr, gi, wyi, AB_p, n2,
                                                   impl=impl),
             (gr, gi, wyi, AB_p), ops_zy, library_inverse(gr, gi, n2))
        case("fy tables", "zy_inv_half_ct",
             lambda impl: ref._zy_inv_half_ct_call(sr, si, wy_g, AB_p, n2,
                                                   impl=impl),
             (sr, si, wy_g, AB_p), ops_zy)
        case("fz tables", "zy_inv_half_ct",
             lambda impl: ref._zy_inv_half_ct_call(sr, si, wyi, AB_g, n2,
                                                   impl=impl),
             (sr, si, wyi, AB_g), ops_zy)
        del sr, si, gr, gi
        torch.cuda.empty_cache()
    del rho
    torch.cuda.empty_cache()
    return records


def phase_compare_bf16(dev):
    """each bf16 form of each DFT kernel against its plain version, on
    the f32 rows' shapes: the ct2 passes in both forms on a lattice
    paint's N^3 density (the records) and on the MXU_SLAB (the z-CT
    forward and inverse), the dense passes at NC^3 and DENSE_RAGGED, the
    row-13 passes at N^3 and REF_SMALL (full spectrum) and CT_RAGGED
    (half CT); every case runs, then any failure raises.  Returns
    {kernel: record}"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    from pmesh_tpu_torch.ops import gridpm as gp
    records, failed = {}, []
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16

    def prec(b):
        return dict(precision='bf16') if b else {}

    def case(label, kernel, call, reads, ops, library=None, storage=False,
             twin=True):
        """call(impl, b): the bf16 form (b) or its f32 twin on the same
        values; the zy inverses of the storage form write f32 meshes and
        need no twin"""
        # a zy pass rounds its intermediate (the z or y output) again as
        # the next product's operand: a chain of two products
        chained = kernel.startswith("zy")
        check = (bf16_storage_check if storage else
                 (lambda *a: bf16_products_check(
                     *a, tol=TOL_CHAIN if chained else TOL_BF16)),
                 (lambda impl: call(impl, False)) if twin else None)
        return dft_case(records, kernel, label,
                        lambda impl: call(impl, True), reads, ops, library,
                        check, failed)

    def combo(label, kernel, call, reads, ops):
        """the _bf16_bf16s combination of a forward ct2 pass: call(impl,
        b) with bf16 products, stored in bf16 (b) or f32 (its twin);
        checked and timed, not a record (no fft mode runs it)"""
        dft_case({}, kernel + "_bf16_bf16s", label,
                 lambda impl: call(impl, True), reads, ops, None,
                 (bf16_once_check, lambda impl: call(impl, False)), failed)

    def combo_x(label, re, im, reads, ops, *a, **kw):
        """combo of an x pass on the spectrum (re, im) rounded to bf16:
        stored so (b), or the same values in f32 (its twin)"""
        hb = (re.to(bf16), im.to(bf16))
        hf = (hb[0].float(), hb[1].float())
        combo(label, "xct_multi", lambda impl, b: fm._xct_call_multi(
            *(hb if b else hf), *a, impl=impl, precision='bf16',
            out_dtype=bf16 if b else None, **kw), reads, ops)

    def density(shape):
        disp = tuple(BOUNDS[0] + (BOUNDS[1] - BOUNDS[0])
                     * torch.rand(shape, generator=gen, device=dev)
                     for _ in range(3))
        return gp.paint_grid(disp, bounds=BOUNDS)

    def noise(shape):
        return 1.0 + 0.3 * torch.randn(shape, generator=gen, device=dev)

    def up(t):
        return t.float()

    # the ct2 passes at N^3: bf16 products on f32 spectra, then f32
    # products on bf16 spectra (the zy inverses read bf16, write f32)
    rho = density((N,) * 3)
    pm = ParticleMesh([N] * 3, BoxSize=BOX, dtype='f4', device=dev)
    _, pk2, kd, _ = Solver(pm)._mxu_setup()
    Zm = N // 2
    wz = fm._cached(fm._z_fwd_tabs, N, Zm)
    wf, wi = (fm._cached(fm._ct_fwd_mats_np, N),
              fm._cached(fm._ct_inv_mats_np, N))
    wx_g = fm._cached(fm._ct_inv_mats_np, N, kd[0])
    wy_g = fm._cached(fm._ct_inv_mats_np, N, kd[1])
    AB_p = fm._cached(fm._z_inv_tabs, N, Zm)
    AB_g = fm._cached(fm._z_inv_tabs, N, Zm, kd[2])
    _, k2m = fm._cached(fm._poisson_tables, pk2, N, N, Zm)
    inv = dict(inverse=True, wx2=wx_g, k2=k2m)
    for form in ("_bf16", "_bf16s"):
        st = form == "_bf16s"

        def spec(impl, b, f, re, im, *a, **kw):
            """pass f on the spectrum (re, im): the form under test (b)
            or its f32 twin (the same values upcast, for the storage
            form)"""
            if not st:
                return f(re, im, *a, impl=impl, **prec(b), **kw)
            if b:
                return f(re, im, *a, impl=impl, out_dtype=bf16, **kw)
            return f(up(re), up(im), *a, impl=impl, **kw)
        pr, pi, nq = case("%d^3 density" % N, "zy_fwd_ct2" + form,
                          lambda impl, b: fm._zy_fwd_ct2_call(
                              rho, N, Zm, wz, wf, impl=impl,
                              **(dict(out_dtype=bf16 if b else None)
                                 if st else prec(b))),
                          (rho, wz, wf), zy_ops(N, N, N),
                          lambda: torch.fft.rfftn(rho, dim=(1, 2)), st)
        if not st:
            # the bf16 products on tc_gemm (one product per real FMA),
            # and stored once in bf16 (the _bf16_bf16s combination)
            tc_share("zy_fwd_ct2 bf16 products %d^3" % N,
                     zy_bf16_fma(N, N, N),
                     cuda_ms(lambda: fm._zy_fwd_ct2_call(
                         rho, N, Zm, wz, wf, precision='bf16'), 5), 1)
            combo("%d^3 density" % N, "zy_fwd_ct2",
                  lambda impl, b: fm._zy_fwd_ct2_call(
                      rho, N, Zm, wz, wf, impl=impl, precision='bf16',
                      out_dtype=bf16 if b else None),
                  (rho, wz, wf), zy_ops(N, N, N))
        zc = torch.complex(up(pr), up(pi))
        r, i = case("forward x 1/N^3", "xct_multi" + form,
                    lambda impl, b: spec(impl, b, fm._xct_call_multi, pr, pi,
                                         wf, 1.0 / N ** 3),
                    (pr, pi, wf), fft_ops(N, N * Zm),
                    lambda: torch.fft.fft(zc, dim=0), st)
        if not st:
            tc_share("xct_multi forward bf16 products %d^3" % N,
                     x_fma(N, N * Zm),
                     cuda_ms(lambda: fm._xct_call_multi(
                         pr, pi, wf, 1.0 / N ** 3, precision='bf16'), 5), 1)
            combo_x("forward x 1/N^3", pr, pi, (pr, pi, wf),
                    fft_ops(N, N * Zm), wf, 1.0 / N ** 3)
        del pr, pi, zc
        sr, si, gr, gi = case("inverse dual (kx-folded), 1/k^2",
                              "xct_multi" + form,
                              lambda impl, b: spec(impl, b,
                                                   fm._xct_call_multi, r, i,
                                                   wi, 1.0, **inv),
                              (r, i, wi, wx_g, k2m), 2 * fft_ops(N, N * Zm),
                              library_dual_x(r, i, k2m), st)
        if not st:
            tc_share("xct_multi dual inverse bf16 products %d^3 (sweeps "
                     "included)" % N, x_fma(N, N * Zm, 2),
                     cuda_ms(lambda: fm._xct_call_multi(
                         r, i, wi, 1.0, precision='bf16', **inv), 5), 1)
            combo_x("inverse dual (kx-folded), 1/k^2", r, i,
                    (r, i, wi, wx_g, k2m), 2 * fft_ops(N, N * Zm), wi, 1.0,
                    **inv)
        del r, i
        plane = nq / N ** 3
        case("fx: plane", "zy_inv_ct2" + form,
             lambda impl, b: fm._zy_inv_ct2_call(
                 gr, gi, wi, AB_p, N, plane=plane, impl=impl,
                 **prec(b and not st)),
             (gr, gi, wi, AB_p, plane), zy_ops(N, N, N),
             library_inverse(up(gr), up(gi), N), st, not st)
        case("(fy, fz), plane on A", "zy_inv_ct2_dual" + form,
             lambda impl, b: fm._zy_inv_ct2_call_dual(
                 sr, si, wy_g, AB_p, wi, AB_g, N, planeA=plane, impl=impl,
                 **prec(b and not st)),
             (sr, si, wy_g, AB_p, wi, AB_g, plane), 2 * zy_ops(N, N, N),
             library_inverse(up(sr), up(si), N, copies=2), st, not st)
        # the zy inverses on tc_gemm: one bf16 product per real FMA, or
        # on a bf16 spectrum the f32 products (three in the y stage)
        for sets, label, call in (
                (1, "zy_inv_ct2", lambda: fm._zy_inv_ct2_call(
                    gr, gi, wi, AB_p, N, plane=plane, **prec(not st))),
                (2, "zy_inv_ct2_dual", lambda: fm._zy_inv_ct2_call_dual(
                    sr, si, wy_g, AB_p, wi, AB_g, N, planeA=plane,
                    **prec(not st)))):
            # bf16s: three products per y FMA (the one-part data), six
            # per z FMA
            fma = zy_inv_fma(N, N, N, sets)
            tc_share("%s%s %d^3" % (label, form, N), fma,
                     cuda_ms(call, 5),
                     6 * zy_inv_fma(N, N, N, sets, 0.5) / fma if st else 1)
            tc_check("%s%s %d^3" % (label, form, N), call)
        del sr, si, gr, gi, nq, plane
        torch.cuda.empty_cache()
    del rho

    # the slab: the z-CT forward and inverse at z = 1024, both forms
    _, N1, n2 = MXU_SLAB
    Zs = n2 // 2
    x = noise(MXU_SLAB)
    AB_s = fm._cached(fm._z_inv_tabs, n2, Zs)
    wys, wyis = (fm._cached(fm._ct_fwd_mats_np, N1),
                 fm._cached(fm._ct_inv_mats_np, N1))
    wzs = fm._cached(fm._z_fwd_tabs, n2, Zs)
    for form in ("_bf16", "_bf16s"):
        st = form == "_bf16s"
        pr, pi, nq = case("slab %s" % (MXU_SLAB,), "zy_fwd_ct2" + form,
                          lambda impl, b: fm._zy_fwd_ct2_call(
                              x, n2, Zs, wzs, wys, impl=impl,
                              **(dict(out_dtype=bf16 if b else None)
                                 if st else prec(b))),
                          (x, wzs, wys), zy_ops(*MXU_SLAB), None, st)
        case("slab, z-CT inverse, plane", "zy_inv_ct2" + form,
             lambda impl, b: fm._zy_inv_ct2_call(
                 pr, pi, wyis, AB_s, n2, plane=nq, impl=impl,
                 **prec(b and not st)),
             (pr, pi, wyis, AB_s, nq), zy_ops(*MXU_SLAB), None, st, not st)
        del pr, pi, nq
    del x
    torch.cuda.empty_cache()

    # the dense passes, bf16 products
    for shape in ((NC,) * 3, DENSE_RAGGED):
        N0, N1, n2 = shape
        Zh = n2 // 2 + 1
        x = density(shape) if shape == (NC,) * 3 else noise(shape)
        dpm = ParticleMesh(list(shape), BoxSize=np.asarray(shape, float),
                           dtype='f4', device=dev)
        _, dk2, dkd, _ = Solver(dpm)._mxu_setup()
        dkd = fm._tuples(dkd)
        wz = fm._cached(fm._dft_half_np, n2, Zh)
        wyf, wxf = (fm._cached(fm._dft_np, N1, -1),
                    fm._cached(fm._dft_np, N0, -1))
        wy, wx = fm._cached(fm._dft_np, N1, +1), fm._cached(fm._dft_np, N0, +1)
        wxg = fm._cached(fm._dft_fold_np, N0, dkd[0])
        AB_p = fm._cached(fm._irfft_mats_np, n2, Zh)
        AB_g = fm._cached(fm._irfft_mats_np, n2, Zh, dkd[2])
        k2 = fm._cached(fm._dense_k2_tables, fm._tuples(dk2), N0, N1, Zh)
        ops_x, ops_zy = fft_ops(N0, N1 * Zh), zy_ops(N0, N1, n2)
        pr, pi = case("%s density" % (shape,), "zy_fwd_half_bf16",
                      lambda impl, b: fm._zy_fwd_dense_call(
                          x, wz, wyf, impl=impl, **prec(b)),
                      (x, wz, wyf), ops_zy,
                      lambda: torch.fft.rfftn(x, dim=(1, 2)))
        del x
        zc = torch.complex(pr, pi)
        r, i = case("%s forward x 1/N^3" % (shape,), "x_dense_bf16",
                    lambda impl, b: fm._x_dense_call(
                        pr, pi, wxf, 1.0 / (N0 * N1 * n2), impl=impl,
                        **prec(b)),
                    (pr, pi, wxf), ops_x, lambda: torch.fft.fft(zc, dim=0))
        del pr, pi, zc
        sr, si, gr, gi = case("%s inverse dual, 1/k^2" % (shape,),
                              "x_dense_bf16",
                              lambda impl, b: fm._x_dense_call(
                                  r, i, wx, 1.0, wx2=wxg, k2=k2, impl=impl,
                                  **prec(b)),
                              (r, i, wx, wxg, k2), 2 * ops_x,
                              library_dual_x(r, i, k2))
        del r, i
        case("%s fx tables" % (shape,), "zy_inv_half_bf16",
             lambda impl, b: fm._zy_inv_dense_call(gr, gi, wy, AB_p,
                                                   impl=impl, **prec(b)),
             (gr, gi, wy, AB_p), ops_zy, library_inverse(gr, gi, n2))
        case("%s fz tables" % (shape,), "zy_inv_half_bf16",
             lambda impl, b: fm._zy_inv_dense_call(sr, si, wy, AB_g,
                                                   impl=impl, **prec(b)),
             (sr, si, wy, AB_g), ops_zy)
        del sr, si, gr, gi
        torch.cuda.empty_cache()

    # row 13, bf16 products: full spectrum, then the first-CT half
    for shape in ((N,) * 3, REF_SMALL):
        N0, N1, n2 = shape
        x = density(shape) if shape == (N,) * 3 else noise(shape)
        kv = tuple(super_lanczos(n) for n in shape)
        wz, wy, wx = (fm._cached(fm._dft_np, n, -1) for n in (n2, N1, N0))
        wyi, wxi = (fm._cached(fm._dft_np, n, +1) for n in (N1, N0))
        wxg = fm._cached(fm._dft_fold_np, N0, kv[0])
        AB = fm._cached(ref._z_inv_full_np, n2, None)
        AB_g = fm._cached(ref._z_inv_full_np, n2, kv[2])
        ops_zy, ops_x = zy_full_ops(N0, N1, n2), fft_ops(N0, N1 * n2)
        pr, pi = case("%s density" % (shape,), "zy_fwd_full_bf16",
                      lambda impl, b: ref._zy_fwd_full_call(
                          x, wz, wy, impl=impl, **prec(b)),
                      (x, wz, wy), ops_zy,
                      lambda: torch.fft.fftn(x, dim=(1, 2)))
        del x
        zc = torch.complex(pr, pi)
        r, i = case("%s forward x 1/N^3" % (shape,),
                    "x_dense_bf16 (full spectrum)",
                    lambda impl, b: fm._x_dense_call(
                        pr, pi, wx, 1.0 / (N0 * N1 * n2), impl=impl,
                        **prec(b)),
                    (pr, pi, wx), ops_x, lambda: torch.fft.fft(zc, dim=0))
        del pr, pi, zc
        sr, si, gr, gi = case("%s inverse dual (kx-folded)" % (shape,),
                              "x_dense_bf16 (full spectrum)",
                              lambda impl, b: fm._x_dense_call(
                                  r, i, wxi, 1.0, wx2=wxg, impl=impl,
                                  **prec(b)),
                              (r, i, wxi, wxg), 2 * ops_x,
                              library_dual_x(r, i))
        del r, i
        zc = torch.complex(gr, gi)
        case("%s fx tables" % (shape,), "zy_inv_full_bf16",
             lambda impl, b: ref._zy_inv_full_call(gr, gi, wyi, AB,
                                                   impl=impl, **prec(b)),
             (gr, gi, wyi, AB), ops_zy,
             lambda: torch.fft.ifftn(zc, dim=(1, 2), norm='forward').real)
        del zc
        case("%s fz tables (z-folded rows)" % (shape,), "zy_inv_full_bf16",
             lambda impl, b: ref._zy_inv_full_call(sr, si, wyi, AB_g,
                                                   impl=impl, **prec(b)),
             (sr, si, wyi, AB_g), ops_zy)
        tc_check("zy_inv_full %s bf16, z-folded rows" % (shape,),
                 lambda: ref._zy_inv_full_call(sr, si, wyi, AB_g,
                                               precision='bf16'))
        del sr, si, gr, gi
        torch.cuda.empty_cache()
    for shape in ((N,) * 3, CT_RAGGED):
        N0, N1, n2 = shape
        Zh = n2 // 2 + 1
        x = density(shape) if shape == (N,) * 3 else noise(shape)
        kd3 = (super_lanczos(N0), super_lanczos(N1),
               super_lanczos(n2, half=True))
        wz = fm._cached(fm._dft_half_np, n2, Zh)
        wy, wx = (fm._cached(fm._ct_fwd_mats_np, n) for n in (N1, N0))
        wyi, wxi = (fm._cached(fm._ct_inv_mats_np, n) for n in (N1, N0))
        wxg = fm._cached(fm._ct_inv_mats_np, N0, kd3[0])
        AB_p = fm._cached(fm._irfft_mats_np, n2, Zh)
        AB_g = fm._cached(fm._irfft_mats_np, n2, Zh, kd3[2])
        ops_zy, ops_x = zy_ops(N0, N1, n2), fft_ops(N0, N1 * Zh)
        pr, pi = case("%s density" % (shape,), "zy_fwd_half_ct_bf16",
                      lambda impl, b: ref._zy_fwd_half_ct_call(
                          x, wz, wy, impl=impl, **prec(b)),
                      (x, wz, wy), ops_zy,
                      lambda: torch.fft.rfftn(x, dim=(1, 2)))
        tc_check("zy_fwd_half_ct %s bf16, density" % (shape,),
                 lambda: ref._zy_fwd_half_ct_call(x, wz, wy,
                                                  precision='bf16'))
        del x
        zc = torch.complex(pr, pi)
        r, i = case("%s forward x 1/N^3" % (shape,),
                    "xct_multi_bf16 (half CT)",
                    lambda impl, b: fm._xct_call_multi(
                        pr, pi, wx, 1.0 / (N0 * N1 * n2), impl=impl,
                        **prec(b)),
                    (pr, pi, wx), ops_x, lambda: torch.fft.fft(zc, dim=0))
        del pr, pi, zc
        sr, si, gr, gi = case("%s inverse dual (kx-folded)" % (shape,),
                              "xct_multi_bf16 (half CT)",
                              lambda impl, b: fm._xct_call_multi(
                                  r, i, wxi, 1.0, inverse=True, wx2=wxg,
                                  impl=impl, **prec(b)),
                              (r, i, wxi, wxg), 2 * ops_x,
                              library_dual_x(r, i))
        del r, i
        case("%s fx tables" % (shape,), "zy_inv_half_ct_bf16",
             lambda impl, b: ref._zy_inv_half_ct_call(
                 gr, gi, wyi, AB_p, n2, impl=impl, **prec(b)),
             (gr, gi, wyi, AB_p), ops_zy, library_inverse(gr, gi, n2))
        case("%s fz tables" % (shape,), "zy_inv_half_ct_bf16",
             lambda impl, b: ref._zy_inv_half_ct_call(
                 sr, si, wyi, AB_g, n2, impl=impl, **prec(b)),
             (sr, si, wyi, AB_g), ops_zy)
        del sr, si, gr, gi
        torch.cuda.empty_cache()
    if failed:
        DEFERRED.append("bf16 forms disagree with their plain versions: "
                        + "; ".join(failed))
    return records


def lattice_need(nsteps):
    """the lattice kernels' launches of a phase-4 run: nsteps + 1
    spectral forces and one gradient force, each one paint and one
    readout (three meshes, or 'all')"""
    return {"paint_lattice": nsteps + 2, "readout_lattice": nsteps + 2}


def phase_main(dev):
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import gridpm_cuda
    pm = ParticleMesh([N] * 3, BoxSize=BOX, dtype='f4', resampler='cic',
                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dlinear = linear_field(pm, gen)
    nsteps = len(STEPS) - 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gridpm_cuda.reset_launches()
    t0 = time.perf_counter()
    solver, disp, vel, S, V = run_path(pm, dlinear, STEPS)
    # the readouts of the nsteps + 1 spectral forces, before the
    # gradient force's 'all': each of three meshes in one launch
    three_mesh = gridpm_cuda.LAUNCHES["readout_lattice"]
    Fg = solver.force_lattice(S, BOUNDS, mode='gradient', fft='xla')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gridpm_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    lpt_max = max(float(d.abs().max()) for d in disp)
    finite = all(bool(torch.isfinite(x).all()) for x in S + V + Fg)
    smax = max(float(s.abs().max()) for s in S)
    rho = gp.paint_grid(S, bounds=BOUNDS)
    mass_err = abs(float(rho.double().sum()) - N ** 3) / N ** 3
    need = lattice_need(nsteps)
    log("phase 4 main path: %d^3 f4 cic, lpt_lattice(order=2) max|disp| "
        "%.4f cells, nbody_lattice %d KDK steps a=%.3f..%.3f + 1 gradient "
        "force in %.3f s (first run), finite %s, final max|S| %.4f cells, "
        "mass error %.3e (tol %.0e), launches %s (need %s), of them "
        "three-mesh readouts %d (need %d), peak %.2f GB"
        % (N, lpt_max, nsteps, STEPS[0], STEPS[-1], wall, finite, smax,
           mass_err, TOL_MASS, json.dumps(launches), json.dumps(need),
           three_mesh, nsteps + 1, peak_gb))
    if not finite:
        raise AssertionError("the state is not finite (bounds poison?)")
    if not smax < BOUNDS[1]:
        raise AssertionError("displacements left the bounds")
    if not mass_err <= TOL_MASS:
        raise AssertionError("paint does not conserve mass")
    if {k: v for k, v in launches.items() if v} != need \
            or three_mesh != nsteps + 1:
        raise AssertionError("the kernels did not carry the main path")
    del Fg, rho

    # one KDK step: (6-step run - 1-step run) / 5, each from the same
    # LPT state; both runs include lpt_lattice and the initial force
    def run(nst):
        return lambda: run_path(pm, dlinear, STEPS[:nst + 1])
    t1 = cuda_ms(run(1), 1)
    t6 = cuda_ms(run(nsteps), 1)
    step_ms = (t6 - t1) / (nsteps - 1)
    f_spec = cuda_ms(lambda: solver.force_lattice(disp, BOUNDS), 3)
    f_grad = cuda_ms(lambda: solver.force_lattice(
        disp, BOUNDS, mode='gradient'), 3)
    log("phase 4 timing: %.3f ms per KDK step (%d-step run %.3f ms, "
        "1-step run %.3f ms), force_lattice spectral %.3f ms, gradient "
        "%.3f ms" % (step_ms, nsteps, t6, t1, f_spec, f_grad))
    del solver, disp, vel
    torch.cuda.empty_cache()
    return launches, dict(pm=pm, dlinear=dlinear, S=S, V=V, step_ms=step_ms,
                          f_spec=f_spec, f_grad=f_grad,
                          three_mesh=three_mesh)


def phase_main_mxu(dev, xla):
    """the phase-4 run with fft='mxu' from the same LPT state: held
    against the fft='xla' run and timed beside it; returns the launch
    counts of the run"""
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import fft_mxu_cuda, gridpm_cuda
    pm, dlinear = xla['pm'], xla['dlinear']
    nsteps = len(STEPS) - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gridpm_cuda.reset_launches()
    fft_mxu_cuda.reset_launches()
    fft_mxu_cuda.kernel_launches(reset=True)
    t0 = time.perf_counter()
    solver, disp, vel, S, V = run_path(pm, dlinear, STEPS, fft='mxu')
    Fg = solver.force_lattice(S, BOUNDS, mode='gradient', fft='mxu')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fft_mxu_cuda.LAUNCHES)
    kinds = fft_mxu_cuda.kernel_launches(reset=True)
    lattice = dict(gridpm_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    finite = all(bool(torch.isfinite(x).all()) for x in S + V + Fg)
    rho = gp.paint_grid(S, bounds=BOUNDS)
    mass_err = abs(float(rho.double().sum()) - N ** 3) / N ** 3
    del rho, Fg
    # against max|S| and max|V| over the three components
    smax = max(float(s.abs().max()) for s in xla['S'])
    vmax = max(float(v.abs().max()) for v in xla['V'])
    dS = max(float((a - b).abs().max()) for a, b in zip(S, xla['S'])) / smax
    dV = max(float((a - b).abs().max()) for a, b in zip(V, xla['V'])) / vmax
    need = {k: (nsteps + 1) * sp + gr for k, (sp, gr) in MXU_PER_FORCE.items()}
    log("phase 4 main path, fft='mxu': the same run (%d KDK steps + 1 "
        "gradient force) in %.3f s (first run), finite %s, mass error %.3e "
        "(tol %.0e), against fft='xla' max|dS|/max|S| = %.3e, "
        "max|dV|/max|V| = %.3e (tol %.0e), launches %s (need %s) and %s, "
        "peak %.2f GB"
        % (nsteps, wall, finite, mass_err, TOL_MASS, dS, dV, TOL_SMALL,
           json.dumps(launches), json.dumps(need), json.dumps(lattice),
           peak_gb))
    if not (finite and mass_err <= TOL_MASS):
        raise AssertionError("the fft='mxu' state is not finite or its "
                             "paint does not conserve mass")
    if not (dS <= TOL_SMALL and dV <= TOL_SMALL):
        raise AssertionError("fft='mxu' and fft='xla' disagree")
    log("phase 4 main path, fft='mxu': device kernels by kind %s"
        % json.dumps(kinds))
    if any(launches[k] < need[k] for k in need) \
            or {k: v for k, v in lattice.items() if v} != lattice_need(
                nsteps):
        raise AssertionError("the DFT kernels did not carry the mxu path")
    if off_tensor_cores(kinds) or not kinds["tc_gemm"]:
        raise AssertionError("the fft='mxu' run launched a kind off the "
                             "tensor cores, or no tc_gemm")
    del xla['S'], xla['V']

    def run(nst):
        return lambda: run_path(pm, dlinear, STEPS[:nst + 1], fft='mxu')
    t1 = cuda_ms(run(1), 1)
    t6 = cuda_ms(run(nsteps), 1)
    step_ms = (t6 - t1) / (nsteps - 1)
    f_spec = cuda_ms(lambda: solver.force_lattice(disp, BOUNDS, fft='mxu'),
                     3)
    f_grad = cuda_ms(lambda: solver.force_lattice(
        disp, BOUNDS, mode='gradient', fft='mxu'), 3)
    log("phase 4 timing, fft='mxu': %.3f ms per KDK step (fft='xla' %.3f; "
        "%d-step run %.3f ms, 1-step run %.3f ms), force_lattice spectral "
        "%.3f ms (xla %.3f), gradient %.3f ms (xla %.3f)"
        % (step_ms, xla['step_ms'], nsteps, t6, t1, f_spec, xla['f_spec'],
           f_grad, xla['f_grad']))
    # the bf16 runs are held against this one
    ref = dict(pm=pm, dlinear=dlinear, S=S, V=V, step_ms=step_ms,
               F=solver.force_lattice(disp, BOUNDS, fft='mxu'))
    del solver, disp, vel
    xla.clear()
    torch.cuda.empty_cache()
    return launches, ref


def rel_rms(got, ref):
    """rms|got - ref| / rms|ref| of each component"""
    return [float((((g - r).double() ** 2).mean()
                   / (r.double() ** 2).mean()) ** 0.5)
            for g, r in zip(got, ref)]


def phase_main_bf16(dev, ref):
    """the phase-4 run (lpt_lattice and 5 KDK steps at N^3) with
    fft='mxu_bf16' and fft='mxu_bf16s', counters read around each run:
    the bf16 forms carried it and no f32 form of a DFT kernel launched;
    finite, a paint conserves mass; one KDK step timed.  Against
    fft='mxu', the force on the LPT state and the final state are
    printed: the reference algorithm rounds the mean density with the
    rest of the spectrum, and that rounding is most of the gap.  Held:
    the same DFT forms on the overdensity (rho - mean) against f32 to
    the sanity bound TOL_BF16_SANITY, and the kernels' force meshes of
    the LPT density against the plain versions' on the card to
    chain_gap.  Returns {fft: launches}."""
    from pmesh_tpu_torch.models.fastpm import _MXU
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import fft_mxu_cuda, gridpm_cuda
    pm, dlinear = ref['pm'], ref['dlinear']
    nsteps = len(STEPS) - 1
    out = {}
    for fft, form in (('mxu_bf16', '_bf16'), ('mxu_bf16s', '_bf16s')):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gridpm_cuda.reset_launches()
        fft_mxu_cuda.reset_launches()
        fft_mxu_cuda.kernel_launches(reset=True)
        solver, disp, vel, S, V = run_path(pm, dlinear, STEPS, fft=fft)
        torch.cuda.synchronize()
        launches = dict(fft_mxu_cuda.LAUNCHES)
        kinds = fft_mxu_cuda.kernel_launches(reset=True)
        lattice = dict(gridpm_cuda.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        need = {k + form: (nsteps + 1) * sp
                for k, (sp, _) in MXU_PER_FORCE.items()}
        others = {k: v for k, v in launches.items() if v and k not in need}
        finite = all(bool(torch.isfinite(x).all()) for x in S + V)
        rho = gp.paint_grid(S, bounds=BOUNDS)
        mass_err = abs(float(rho.double().sum()) - N ** 3) / N ** 3
        dS, dV = rel_rms(S, ref['S']), rel_rms(V, ref['V'])
        del rho, S, V
        F = solver.force_lattice(disp, BOUNDS, fft=fft)
        finite = finite and all(bool(torch.isfinite(f).all()) for f in F)
        dF = rel_rms(F, ref['F'])
        del F
        # the DFT forms alone, on the LPT density: kernels against the
        # plain versions on the card, and on the overdensity against f32
        shape, pk2, kd, _ = solver._mxu_setup()
        prec, sdt = _MXU[fft]
        rho = gp.paint_grid(disp, bounds=BOUNDS)
        got = solver._mxu_force_raw(rho, _MXU[fft])
        f32 = solver._mxu_force_raw(rho)
        plain = fm.fft3_real_inverse_grad3_half_ct2(
            *fm.fft3_real_forward_half_ct2(rho, precision=prec,
                                           spectrum_dtype=sdt, impl='torch'),
            n2=N, kvecs=kd, precision=prec, poisson_k2=pk2, impl='torch')
        chain_ok, chain_line = chain_gap(
            [t.cpu().numpy() for t in got], [t.cpu().numpy() for t in plain],
            [t.cpu().numpy() for t in f32], TOL_FORCE_RMS)
        del got, f32, plain
        delta = rho - rho.mean()
        del rho
        dD = rel_rms(solver._mxu_force_raw(delta, _MXU[fft]),
                     solver._mxu_force_raw(delta))
        del delta
        sane = all(np.isfinite(e) and e < TOL_BF16_SANITY for e in dD)
        log("phase 4 main path, fft=%r: %d KDK steps, finite %s, mass error "
            "%.3e (tol %.0e), launches %s (need %s, others %s), lattice %s, "
            "peak %.2f GB; against fft='mxu' rms|d|/rms (x, y, z): force on "
            "the LPT state %s, final S %s, final V %s"
            % (fft, nsteps, finite, mass_err, TOL_MASS,
               json.dumps({k: launches[k] for k in need}), json.dumps(need),
               json.dumps(others), json.dumps(lattice), peak_gb,
               fmt3(dF), fmt3(dS), fmt3(dV)))
        log("phase 4 main path, fft=%r: device kernels by kind %s"
            % (fft, json.dumps(kinds)))
        if fft == 'mxu_bf16':
            want = {k: (nsteps + 1) * v
                    for k, v in BF16_KINDS_PER_FORCE.items()}
            if kinds != want:
                DEFERRED.append(
                    "the fft='mxu_bf16' run launched %s device kernels, not "
                    "%s: a bf16 pass off tc_gemm" % (json.dumps(kinds),
                                                     json.dumps(want)))
        elif off_tensor_cores(kinds) or not kinds["tc_gemm"]:
            DEFERRED.append("the fft=%r run launched a kind off the tensor "
                            "cores, or no tc_gemm: %s"
                            % (fft, json.dumps(kinds)))
        log("phase 4 %s force meshes of the LPT density: kernels vs plain "
            "versions on the card %s; on the overdensity rho - mean against "
            "f32 rms|d|/rms %s (sanity bound %.0e)"
            % (fft, chain_line, fmt3(dD), TOL_BF16_SANITY))
        if not (finite and mass_err <= TOL_MASS and sane):
            raise AssertionError("the fft=%r run is not finite, loses mass "
                                 "or its DFT forms are wrong" % fft)
        if not chain_ok:
            DEFERRED.append("the fft=%r force meshes disagree with the "
                            "plain versions'" % fft)
        # and one paint and one three-mesh readout per spectral force
        spectral = {"paint_lattice": nsteps + 1,
                    "readout_lattice": nsteps + 1}
        if any(launches[k] != need[k] for k in need) or others \
                or {k: v for k, v in lattice.items() if v} != spectral:
            raise AssertionError("the %s kernels did not carry the fft=%r "
                                 "run alone" % (form, fft))

        def run(nst):
            return lambda: run_path(pm, dlinear, STEPS[:nst + 1], fft=fft)
        t1 = cuda_ms(run(1), 1)
        t6 = cuda_ms(run(nsteps), 1)
        f_spec = cuda_ms(lambda: solver.force_lattice(disp, BOUNDS, fft=fft),
                         3)
        log("phase 4 timing, fft=%r: %.3f ms per KDK step (fft='mxu' %.3f; "
            "%d-step run %.3f ms, 1-step run %.3f ms), force_lattice "
            "spectral %.3f ms" % (fft, (t6 - t1) / (nsteps - 1),
                                  ref['step_ms'], nsteps, t6, t1, f_spec))
        out[fft] = launches
        del solver, disp, vel
        torch.cuda.empty_cache()
    ref.clear()
    torch.cuda.empty_cache()
    return out


def fmt3(errs):
    return "(%s)" % ", ".join("%.3e" % e for e in errs)


def phase_row13(dev, pm, dlinear):
    """the row-13 pipelines as forces on phase 4's LPT state, counters
    read around the run: the painted overdensity through fft3_real_forward,
    1/k^2 (full-length z), fft3_real_inverse_grad3 with the solver's
    SuperLanczos k_d and the lattice readout, held against
    force_lattice(fft='xla'); fft3_real_forward_half_ct and
    fft3_real_inverse_grad3_half_ct (i*k_d alone), held against the ct2
    triple; and the full round trip against the density.
    Returns the launch counts of the run."""
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import fft_mxu_ref as ref
    from pmesh_tpu_torch.ops import fft_mxu_cuda, gridpm_cuda
    from pmesh_tpu_torch.ops import gridpm as gp
    solver = Solver(pm)
    disp, _ = solver.lpt_lattice(dlinear, A0, order=2)
    _, pk2, kd, ct = solver._mxu_setup()
    assert ct
    cell = BOX / N
    kz = np.fft.fftfreq(N, d=cell) * 2 * np.pi
    kvecs = (kd[0], kd[1], super_lanczos(N, cell))
    factor = 1.5 * solver.cosmology.Om0

    def invk2(kx2, ky2, kz2):
        t = [torch.tensor(np.asarray(a, np.float32), device=dev)
             for a in (kx2, ky2, kz2)]
        kk = t[0][:, None, None] + t[1][None, :, None] + t[2][None, None]
        return torch.where(kk > 0, 1.0 / torch.where(kk > 0, kk, 1.0), 0.0)
    full_k2 = invk2(pk2[0], pk2[1], (kz ** 2).astype('f4'))
    def overdensity():
        # the DC mode carries no force; without it the products' rounding
        # does not scale with the mean density
        rho = gp.paint_grid(disp, bounds=BOUNDS)
        return rho - rho.mean()
    # the references, outside the counted run; the ct2 triple without
    # 1/k^2, as tests/test_fft_mxu.py holds ct2 against the dense triple
    F_xla = solver.force_lattice(disp, BOUNDS, fft='xla')
    F_ct2 = fm.fft3_real_inverse_grad3_half_ct2(
        *fm.fft3_real_forward_half_ct2(overdensity()), n2=N, kvecs=kd)
    torch.cuda.synchronize()
    gridpm_cuda.reset_launches()
    fft_mxu_cuda.reset_launches()
    rho = overdensity()
    r, i = ref.fft3_real_forward(rho)
    f = ref.fft3_real_inverse_grad3(r * full_k2, i * full_k2, kvecs=kvecs)
    F13 = tuple(v * factor for v in gp.readout_grid(f, disp, bounds=BOUNDS))
    del f, r, i
    fh = ref.fft3_real_inverse_grad3_half_ct(
        *ref.fft3_real_forward_half_ct(rho), N, kd)
    back = ref.fft3_real_inverse(*ref.fft3_real_forward(rho))
    torch.cuda.synchronize()
    launches = dict(fft_mxu_cuda.LAUNCHES)
    lattice = {k: v for k, v in gridpm_cuda.LAUNCHES.items() if v}
    e_full = max_rel(F13, F_xla)[0]
    e_ct = max_rel(fh, F_ct2)[0]
    e_rt = float((back - rho).abs().max() / rho.abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in F13 + fh)
    del F13, fh, back, F_xla, F_ct2
    ok = (finite and e_full <= TOL_SMALL and e_ct <= TOL_CT_TRIPLE
          and e_rt <= TOL_ROUNDTRIP)
    counted = {k: launches[k] for k in ROW13_PATH}
    log("phase 4c row-13 path: %d^3 LPT state, full-spectrum force "
        "(fft3_real_forward, 1/k^2, fft3_real_inverse_grad3, readout) "
        "against force_lattice(fft='xla') max|dF|/max|F| = %.3e (tol %.0e);"
        " half-CT triple against the ct2 triple %.3e (tol %.0e); full round"
        " trip max|d|/max|delta| %.3e (tol %.0e); finite %s; DFT launches %s "
        "(need %s), lattice %s %s"
        % (N, e_full, TOL_SMALL, e_ct, TOL_CT_TRIPLE, e_rt, TOL_ROUNDTRIP,
           finite, json.dumps(counted), json.dumps(ROW13_PATH),
           json.dumps(lattice), "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the row-13 path disagrees with its references")
    if counted != ROW13_PATH or lattice != {"paint_lattice": 1,
                                            "readout_lattice": 1}:
        raise AssertionError("the row-13 kernels did not carry the path")
    r, i = ref.fft3_real_forward(rho)
    fr, fi = r * full_k2, i * full_k2
    hr, hi = ref.fft3_real_forward_half_ct(rho)
    t_fwd = cuda_ms(lambda: ref.fft3_real_forward(rho), 3)
    t_tri = cuda_ms(lambda: ref.fft3_real_inverse_grad3(fr, fi,
                                                        kvecs=kvecs), 3)
    t_hfwd = cuda_ms(lambda: ref.fft3_real_forward_half_ct(rho), 3)
    t_htri = cuda_ms(lambda: ref.fft3_real_inverse_grad3_half_ct(
        hr, hi, N, kd), 3)
    log("phase 4c timing: fft3_real_forward %.3f ms, fft3_real_inverse_grad3"
        " %.3f ms, fft3_real_forward_half_ct %.3f ms, "
        "fft3_real_inverse_grad3_half_ct %.3f ms (%d^3)"
        % (t_fwd, t_tri, t_hfwd, t_htri, N))

    # the same path with precision='bf16', counted apart, against the
    # f32 results to the sanity bound
    f32 = (ref.fft3_real_inverse_grad3(fr, fi, kvecs=kvecs),
           ref.fft3_real_inverse_grad3_half_ct(hr, hi, N, kd), rho)
    del r, i, hr, hi
    bf = dict(precision='bf16')
    torch.cuda.synchronize()
    fft_mxu_cuda.reset_launches()
    r, i = ref.fft3_real_forward(rho, **bf)
    f = ref.fft3_real_inverse_grad3(r * full_k2, i * full_k2, kvecs=kvecs,
                                    **bf)
    fh = ref.fft3_real_inverse_grad3_half_ct(
        *ref.fft3_real_forward_half_ct(rho, **bf), N, kd, **bf)
    back = ref.fft3_real_inverse(*ref.fft3_real_forward(rho, **bf), **bf)
    torch.cuda.synchronize()
    bf_launches = dict(fft_mxu_cuda.LAUNCHES)
    counted = {k + "_bf16": bf_launches[k + "_bf16"] for k in ROW13_PATH}
    need = {k + "_bf16": v for k, v in ROW13_PATH.items()}
    others = {k: v for k, v in bf_launches.items() if v and k not in need}
    errs = (max(rel_rms(f, f32[0])), max(rel_rms(fh, f32[1])),
            rel_rms((back,), (f32[2],))[0])
    finite = all(bool(torch.isfinite(t).all()) for t in f + fh + (back,))
    ok = finite and all(e < TOL_BF16_SANITY for e in errs)
    log("phase 4c row-13 path, precision='bf16': against f32 rms|d|/rms = "
        "%.3e (full-spectrum triple), %.3e (half-CT triple), %.3e (round "
        "trip); finite %s; launches %s (need %s, others %s) %s"
        % (errs + (finite, json.dumps(counted), json.dumps(need),
                   json.dumps(others), "ok" if ok else "FAIL")))
    if not ok:
        raise AssertionError("the bf16 row-13 path is not finite or far "
                             "from f32")
    if counted != need or others:
        raise AssertionError("the bf16 row-13 kernels did not carry the "
                             "path alone")
    del f, fh, back, f32, r, i
    hr, hi = ref.fft3_real_forward_half_ct(rho, **bf)
    t_fwd = cuda_ms(lambda: ref.fft3_real_forward(rho, **bf), 3)
    t_tri = cuda_ms(lambda: ref.fft3_real_inverse_grad3(fr, fi, kvecs=kvecs,
                                                        **bf), 3)
    t_hfwd = cuda_ms(lambda: ref.fft3_real_forward_half_ct(rho, **bf), 3)
    t_htri = cuda_ms(lambda: ref.fft3_real_inverse_grad3_half_ct(
        hr, hi, N, kd, **bf), 3)
    log("phase 4c timing, precision='bf16': fft3_real_forward %.3f ms, "
        "fft3_real_inverse_grad3 %.3f ms, fft3_real_forward_half_ct %.3f "
        "ms, fft3_real_inverse_grad3_half_ct %.3f ms (%d^3)"
        % (t_fwd, t_tri, t_hfwd, t_htri, N))
    del fr, fi, hr, hi, rho, full_k2, disp, solver
    torch.cuda.empty_cache()
    return launches, bf_launches


def grad_run(solver, state, steps, fft, backward=True):
    """the gradient of sum(S^2 + 2 V^2) after nbody_lattice (spectral
    force) with respect to the initial (disp, vel) ``state``"""
    leaves = [t.detach().clone().requires_grad_() for t in state]
    S, V = solver.nbody_lattice(leaves[:3], leaves[3:], steps, BOUNDS,
                                fft=fft)
    loss = sum((s * s).sum() + 2 * (v * v).sum() for s, v in zip(S, V))
    if not backward:
        return loss
    return torch.autograd.grad(loss, leaves)


def grad_gap(got, ref, tol, outliers):
    """got against ref over the tensors: whether at most ``outliers`` of
    the entries are off by more than ``tol`` max|ref|, and a line giving
    that count, max|got - ref| / max|ref| and the 2-norm gap"""
    num = sum(float(((g - r).double() ** 2).sum()) for g, r in zip(got, ref))
    den = sum(float((r.double() ** 2).sum()) for r in ref)
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    out = sum(int(((g - r).abs() > tol * scale).sum())
              for g, r in zip(got, ref))
    size = sum(r.numel() for r in ref)
    ok = bool(np.isfinite(num)) and out <= outliers * size
    return ok, ("%d of %d entries off by more than %.0e of max|g| (at most "
                "%d allowed) %s; max|dg|/max|g| = %.3e, |dg|_2/|g|_2 = %.3e"
                % (out, size, tol, int(outliers * size),
                   "ok" if ok else "FAIL", err / scale, (num / den) ** 0.5))


def phase_grad(dev, pm, dlinear, refdir=None):
    """reverse mode at N^3 from phase 4's LPT state: the gradient of a
    2-step nbody_lattice loss with fft='xla' and fft='mxu', counters
    read around each run; finite, the two within TOL_GRAD of max|g| but
    for GRAD_OUTLIERS of the entries (with TSC for none), the backward on
    the paint, readout (diffdir) and only=d DFT kernels; the forward
    alone and forward + backward per KDK step (a 2-step run minus a
    1-step run), and the peak memory"""
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import fft_mxu_cuda, gridpm_cuda
    solver = Solver(pm)
    state = sum(solver.lpt_lattice(dlinear, A0, order=2), ())
    forces = len(GRAD_STEPS)
    grads = {}
    for fft in ('xla', 'mxu'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gridpm_cuda.reset_launches()
        fft_mxu_cuda.reset_launches()
        g = grad_run(solver, state, GRAD_STEPS, fft)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = dict(gridpm_cuda.LAUNCHES, **fft_mxu_cuda.LAUNCHES)
        need = {k: forces * (f + b) for k, (f, b) in GRAD_LATTICE.items()}
        if fft == 'mxu':
            need.update((k, forces * (f + b)) for k, (f, b) in GRAD_MXU.items())
        got = {k: launches[k] for k in need}
        others = {k: v for k, v in launches.items() if k not in need and v}
        finite = all(bool(torch.isfinite(t).all()) for t in g)
        t = {}
        for nst in (1, 2):
            steps = GRAD_STEPS[:nst + 1]
            t['f%d' % nst] = cuda_ms(lambda: grad_run(solver, state, steps,
                                                      fft, False), 1)
            t['b%d' % nst] = cuda_ms(lambda: grad_run(solver, state, steps,
                                                      fft), 1)
        log("phase 4d gradient, fft=%r: %d^3 d/d(disp, vel) of sum(S^2 + "
            "2 V^2) after %d KDK steps: finite %s, max|g| %.4e, launches %s "
            "(need %s, others %s), peak %.2f GB; per KDK step forward %.3f "
            "ms, forward + backward %.3f ms (2-step runs %.3f / %.3f ms, "
            "1-step %.3f / %.3f ms)"
            % (fft, N, forces - 1, finite, max(float(x.abs().max())
                                               for x in g),
               json.dumps(got), json.dumps(need), json.dumps(others), peak_gb,
               t['f2'] - t['f1'], t['b2'] - t['b1'], t['f2'], t['b2'],
               t['f1'], t['b1']))
        if not finite:
            raise AssertionError("the fft=%r gradient is not finite" % fft)
        if got != need or others:
            raise AssertionError("the backward did not run on the kernels "
                                 "(fft=%r)" % fft)
        grads[fft] = g
    ok, line = grad_gap(grads['mxu'], grads['xla'], TOL_GRAD, GRAD_OUTLIERS)
    log("phase 4d gradient: fft='mxu' against fft='xla', CIC: " + line)
    if not ok:
        raise AssertionError("the mxu and xla gradients disagree")
    if refdir is not None:
        # phase 16(a)'s reference: each rank reads its slab
        for k, x in enumerate(grads['mxu']):
            np.save(os.path.join(refdir, 'grad4d_%d.npy' % k),
                    x.cpu().numpy())
    del grads
    # TSC, whose derivative window is continuous: no entry may differ
    tsc = Solver(pm, force_resampler='tsc')
    grads = {fft: grad_run(tsc, state, GRAD_STEPS, fft)
             for fft in ('xla', 'mxu')}
    ok, line = grad_gap(grads['mxu'], grads['xla'], TOL_GRAD, 0)
    log("phase 4d gradient: fft='mxu' against fft='xla', TSC: " + line)
    if not ok:
        raise AssertionError("the mxu and xla TSC gradients disagree")
    del grads, state, solver, tsc
    torch.cuda.empty_cache()


def phase_small_grad(dev, shape, box, fft, model='lattice'):
    """the gradient of a 2-step run on the card (kernels in the
    backward) against the CPU's (plain versions); up to GRAD_OUTLIERS of
    the entries may differ, as CIC's derivative jumps at cell
    boundaries; a bf16 mode to TOL_CHAIN of max|g| (its flips).
    ``model``: 'lattice' (nbody_lattice), 'catalog' (phase 13(a)'s model
    at shape[0]^3 particles, B = CAT_B) or 'binned' (phase 13(b)'s
    force_binned gradient, K = BINNED_GRAD_K)"""
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    rng = np.random.RandomState(SEED + 1)
    noise = rng.normal(size=shape).astype('f4')
    disp = tuple(0.05 + 0.9 * rng.uniform(size=shape).astype('f4')
                 for _ in range(3))
    out = {}
    for device in ('cpu', dev):
        if model == 'catalog':
            solver, power, white = catalog_setup(device, shape[0], box)
            g = catalog_grad(solver, power, white)
        elif model == 'binned':
            pm = ParticleMesh(list(shape), BoxSize=box, dtype='f4',
                              resampler='cic', device=device)
            dslots, valid = bn.from_lattice(
                tuple(torch.from_numpy(d).to(device) for d in disp),
                nslots=BINNED_GRAD_K)
            g = binned_grad_run(Solver(pm), dslots, valid, (-0.5, 1.5), fft)
        else:
            pm = ParticleMesh(list(shape), BoxSize=box, dtype='f4',
                              resampler='cic', device=device)
            dk = pm.create(type=RealField,
                           value=torch.from_numpy(noise).to(device)).r2c()
            dk = dk.apply(lambda k, v: 0.3 * v * torch.where(
                k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.25, 0.0))
            solver = Solver(pm)
            state = sum(solver.lpt_lattice(dk, A0, order=2), ())
            g = grad_run(solver, state, STEPS[:3], fft)
        out[str(device)] = [x.cpu() for x in as_tuple(g)]
    bf16 = fft.startswith('mxu_bf16')
    ok, line = grad_gap(out[str(dev)], out['cpu'],
                        TOL_CHAIN if bf16 else TOL_SMALL, GRAD_OUTLIERS)
    what = {'lattice': "2 KDK steps",
            'catalog': "catalog model, B=%d, 2LPT + 2 KDK steps" % CAT_B,
            'binned': "force_binned K=%d" % BINNED_GRAD_K}[model]
    log("phase %s small gradient: %s fft=%r %s, card vs CPU: %s"
        % ("7" if model == 'lattice' else "13(c)", shape, fft, what, line))
    if not ok and bf16:
        DEFERRED.append("the card and the CPU gradients disagree at %s, "
                        "fft=%r" % (shape, fft))
    elif not ok:
        raise AssertionError("the card and the CPU gradients disagree at "
                             "%s, fft=%r (%s)" % (shape, fft, model))


def chain_gap(got, ref, ref32, rms_tol=None):
    """the criterion of a chain of bf16 passes, over numpy arrays: (ok,
    line) with max|got - ref| <= TOL_CHAIN max|ref| and, with
    ``rms_tol``, per array rms|got - ref| <= rms_tol rms|ref - ref32|
    (ref32: the same run in f32, so the denominator is the bf16
    rounding; printed in any case)"""
    scale = max(float(np.abs(r).max()) for r in ref)
    gap = max(float(np.abs(g - r).max()) for g, r in zip(got, ref)) / scale
    rms = max(float(np.sqrt(((g - r) ** 2).mean() / ((r - f) ** 2).mean()))
              for g, r, f in zip(got, ref, ref32))
    ok = bool(np.isfinite(gap) and gap <= TOL_CHAIN
              and (rms_tol is None or rms <= rms_tol))
    return ok, ("max|d|/max = %.3e (tol %.0e), rms|d| / rms|bf16 - f32| = "
                "%.3f (tol %s) %s" % (gap, TOL_CHAIN, rms,
                                      "none" if rms_tol is None
                                      else "%.2f" % rms_tol,
                                      "ok" if ok else "FAIL"))


def phase_small(dev, shape=(32,) * 3, box=64.0, fft='xla'):
    """a small lattice run on the card (kernels; cuFFT or the DFT
    kernels) against the same run on the CPU (plain versions); a bf16
    mode is held to chain_gap, with the CPU's fft='mxu' run as the f32
    reference."""
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.fastpm import Solver
    noise = np.random.RandomState(SEED).normal(size=shape).astype('f4')
    out = {}
    runs = [('cpu', fft), (dev, fft)]
    if fft.startswith('mxu_bf16'):
        runs.append(('cpu', 'mxu'))
    for device, f in runs:
        pm = ParticleMesh(list(shape), BoxSize=box, dtype='f4',
                          resampler='cic', device=device)
        dk = pm.create(type=RealField,
                       value=torch.from_numpy(noise).to(device)).r2c()
        dk = dk.apply(lambda k, v: 0.3 * v * torch.where(
            k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.25, 0.0))
        solver = Solver(pm)
        disp, vel = solver.lpt_lattice(dk, A0, order=2)
        S, V = solver.nbody_lattice(disp, vel, STEPS[:4], BOUNDS, fft=f)
        out[str(device) if f == fft else f] = [x.cpu().numpy()
                                               for x in S + V]
    ref, got = out['cpu'], out[str(dev)]
    if fft.startswith('mxu_bf16'):
        ok, line = chain_gap(got, ref, out['mxu'])
        smax = max(np.abs(s).max() for s in ref[:3])
        ok = ok and 0.01 < smax < BOUNDS[1]
        log("phase 7 small input: %s lattice fft=%r 3 KDK steps, card vs "
            "CPU (S, V): %s, max|S| %.4f" % (shape, fft, line, smax))
        if not ok:
            DEFERRED.append("the card and the CPU disagree at %s, fft=%r"
                            % (shape, fft))
        return
    smax = max(np.abs(s).max() for s in ref[:3])
    err = max(np.abs(a - b).max() for a, b in zip(ref[:3], got[:3])) / smax
    vmax = max(np.abs(v).max() for v in ref[3:])
    verr = max(np.abs(a - b).max() for a, b in zip(ref[3:], got[3:])) / vmax
    ok = (np.isfinite(err) and err <= TOL_SMALL and verr <= TOL_SMALL
          and 0.01 < smax < BOUNDS[1])
    log("phase 7 small input: %s lattice fft=%r 3 KDK steps, card vs CPU "
        "max|dS|/max|S| = %.3e, max|dV|/max|V| = %.3e (tol %.0e), "
        "max|S| %.4f %s"
        % (shape, fft, err, verr, TOL_SMALL, smax, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card and the CPU disagree at %s, fft=%r"
                             % (shape, fft))


def rebase_state(dev, gen, n, drift, fill=(1.0, 0.25)):
    """A binned state at n^3 made the way bench.py's measure_binned
    makes it (displacements in [0.05, 0.95), velocities 0.02 N(0, 1)),
    plus a drift uniform in [-drift, drift); slot k a fraction fill[k]
    full (the default: K = 2, the second slot a quarter full)."""
    shape = (n,) * 3

    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    dslots = tuple(tuple(uni(0.05, 0.95) + uni(-drift, drift)
                         for _ in range(3)) for _ in fill)
    valid = tuple((uni(0.0, 1.0) < f).float() for f in fill)
    vslots = tuple(tuple(0.02 * torch.randn(shape, generator=gen,
                                            device=dev) for _ in range(3))
                   for _ in fill)
    return dslots, vslots, valid


def max_abs_diff(got, ref):
    """max |got - ref| over nested tuples of tensors (0 if all equal)"""
    if isinstance(ref, (tuple, list)):
        return max(max_abs_diff(g, r) for g, r in zip(got, ref))
    return float((got.double() - ref.double()).abs().max())


def bitwise_equal(got, ref):
    if isinstance(ref, (tuple, list)):
        return all(bitwise_equal(g, r) for g, r in zip(got, ref))
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), ref.view(torch.int32))
    return torch.equal(got, ref)


def phase_compare_rebase(dev, cases=REBASE_CASES):
    """rebase assign and apply, kernel vs plain for each of REBASE_CASES:
    bitwise; returns {kernel: record} of the first case (the main
    path's)"""
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.ops import binned_cuda
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    records = {}
    for bounds, fill, kout, n in cases:
        # keep the displacements inside the bounds: [lo, hi)
        drift = min(0.05 - bounds[0], bounds[1] - 0.95)
        dslots, vslots, valid = rebase_state(dev, gen, n, drift, fill)
        offsets = bn._drift_offsets(bounds, 3)
        lo, hi = offsets[0][0], offsets[-1][0]

        def assign(impl):
            if impl == 'cuda':
                return binned_cuda.rebase_assign(dslots, valid, kout, lo, hi)
            return bn.rebase_assign_plain(dslots, valid, offsets, kout)

        def apply(impl, routes):
            if impl == 'cuda':
                return binned_cuda.rebase_apply((vslots,), routes, lo, hi)
            return bn.rebase_apply_plain((vslots,), routes, offsets)

        plain = assign('torch')
        got = assign('cuda')
        plain_e = apply('torch', plain[2])
        got_e = apply('cuda', got[2])
        same = (bitwise_equal(got, plain) and bitwise_equal(got_e, plain_e))
        err = dict(rebase_assign=max_abs_diff(got, plain),
                   rebase_apply=max_abs_diff(got_e, plain_e))
        ms = dict(rebase_assign=cuda_ms(lambda: assign('cuda'), 5),
                  rebase_apply=cuda_ms(lambda: apply('cuda', got[2]), 5))
        plain_ms = dict(
            rebase_assign=cuda_ms(lambda: assign('torch'), 1),
            rebase_apply=cuda_ms(lambda: apply('torch', got[2]), 1))
        log("phase 3 compare: rebase %d^3 K=%d->%d bounds=%s offsets "
            "%d..%d overflow kernel %d plain %d, bitwise %s, max|k-p| "
            "assign %g apply %g  assign kernel %.3f ms plain %.3f ms, apply "
            "kernel %.3f ms plain %.3f ms"
            % (n, len(fill), kout, bounds, lo, hi, int(got[3]),
               int(plain[3]),
               "equal" if same else "DIFFERENT", err['rebase_assign'],
               err['rebase_apply'], ms['rebase_assign'],
               plain_ms['rebase_assign'], ms['rebase_apply'],
               plain_ms['rebase_apply']))
        if not same or int(got[3]) != int(plain[3]):
            raise AssertionError("the rebase kernels disagree with their "
                                 "plain versions")
        moved = dict(rebase_assign=nbytes(dslots, valid, got[:3]),
                     rebase_apply=nbytes(vslots, got[2], got_e))
        ops = dict(rebase_assign=REBASE_OPS * len(dslots) * n ** 3,
                   rebase_apply=0)
        for name in err:
            if name not in records:
                records[name] = record(err[name], ms[name], plain_ms[name],
                                       moved[name], ops[name])
            records[name]["max_abs_err"] = max(
                records[name]["max_abs_err"], err[name])
        del dslots, vslots, valid, plain, got, plain_e, got_e
        torch.cuda.empty_cache()
    return records


def caustic_state(dev, n, ax=CAUSTIC_AX, lam=CAUSTIC_LAM):
    """bench.py's clustered initial state: a caustic-forming x-flow
    modulated along y/z plus sub-cell y/z displacements (numpy
    RandomState(7)), velocities 0.02 N(0, 1) from a seeded generator"""
    q1 = np.arange(n, dtype=np.float64)
    ph = 2 * np.pi * q1 / lam
    rng = np.random.RandomState(7)
    mod = 1.0 + 0.3 * (np.sin(ph + 0.7)[:, None]
                       * np.sin(ph + 1.3)[None, :])
    sx = (-ax * np.sin(ph)[:, None, None] * mod[None, :, :]
          + rng.uniform(-0.2, 0.2, (n, n, n)))
    sy = np.broadcast_to((0.25 + 0.2 * np.sin(ph + 0.3))[:, None, None],
                         (n, n, n))
    sz = np.broadcast_to((0.25 + 0.2 * np.cos(ph + 0.9))[None, :, None],
                         (n, n, n))
    disp = tuple(torch.from_numpy(np.ascontiguousarray(s, dtype='f4'))
                 .to(dev) for s in (sx, sy, sz))
    gen = torch.Generator(device=dev).manual_seed(1)
    vel = tuple(0.02 * torch.randn((n,) * 3, generator=gen, device=dev)
                for _ in range(3))
    return disp, vel


def phase_binned_clustered(dev, n=NC):
    """the binned path's main run, as bench.py's measure_binned_clustered
    makes it: adaptive growth on the caustic flow with fft='mxu' (the
    dense DFT passes at 384^3); returns the launch counts of the run and
    the solver and grown state for phase_clustered_timed"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.ops import binned_cuda, fft_mxu_cuda, gridpm_cuda
    disp, vel = caustic_state(dev, n)
    pm = ParticleMesh([n] * 3, BoxSize=float(n), dtype='f4',
                      resampler='cic', device=dev)
    solver = Solver(pm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gridpm_cuda.reset_launches()
    binned_cuda.reset_launches()
    fft_mxu_cuda.reset_launches()
    fft_mxu_cuda.kernel_launches(reset=True)
    t0 = time.perf_counter()
    dslots, vslots, valid, overflow = solver.nbody_binned(
        disp, vel, CLUSTERED_STEPS, adaptive=True, **CLUSTERED_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(gridpm_cuda.LAUNCHES, **binned_cuda.LAUNCHES)
    dft = dict(fft_mxu_cuda.LAUNCHES)
    kinds = fft_mxu_cuda.kernel_launches(reset=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    del disp, vel
    stats = dict(solver.last_binned_stats)
    tot, occ = bn.occupancy(valid)
    tot, occ, ov = int(tot), float(occ), int(overflow)
    finite = all(bool(torch.isfinite(x).all())
                 for slot in dslots + vslots for x in slot)
    mass = float(bn.paint_binned(dslots, valid).double().sum())
    mass_err = abs(mass - tot) / tot
    # one force before the loop and one per KDK step
    forces = len(CLUSTERED_STEPS)
    need = {k: forces * c for k, c in DENSE_PER_FORCE.items()}
    need_kinds = {k: forces * c for k, c in DENSE_KINDS_PER_FORCE.items()}
    log("phase 5 binned, clustered: %d^3 caustic (Ax=%g, lam=%g) "
        "nbody_binned(adaptive, fft='mxu') %d KDK steps + 1 rebase in "
        "%.3f s (first run): growth events %d, K %d -> %d, max occupancy "
        "%g, overflow %d, particles %d of %d, paint mass error %.3e (tol "
        "%.0e), finite %s, peak %.2f GB, launches %s, DFT launches %s "
        "(need %s), DFT kernels by kind %s (need %s)"
        % (n, CAUSTIC_AX, CAUSTIC_LAM, forces - 1, wall,
           stats['growth_events'], CLUSTERED_KW['nslots'], len(dslots), occ,
           ov, tot, n ** 3, mass_err, TOL_MASS, finite, peak_gb,
           json.dumps(launches), json.dumps(dft), json.dumps(need),
           json.dumps(kinds), json.dumps(need_kinds)))
    if not (stats['growth_events'] >= 1 and len(dslots) >= 3):
        raise AssertionError("the adaptive path did not grow the slots")
    if ov != 0 or stats['overflow'] != 0 or tot != n ** 3:
        raise AssertionError("particles overflowed or were lost")
    if not (finite and mass_err <= TOL_MASS):
        raise AssertionError("the binned state is not finite or its "
                             "paint does not conserve the count")
    # each spectral force paints every slot once and reads its three
    # meshes at every slot in one launch
    if min(launches[k] for k in ("paint_lattice", "readout_lattice",
                                 "rebase_assign", "rebase_apply")) < 1 \
            or launches["readout_lattice"] != launches["paint_lattice"]:
        raise AssertionError("the kernels did not carry the binned path")
    if any(dft[k] != need.get(k, 0) for k in dft):
        raise AssertionError("the dense DFT kernels did not carry the "
                             "clustered run's forces")
    if kinds != need_kinds:
        raise AssertionError("the clustered run's forward DFT passes did "
                             "not run on tc_gemm alone")
    launches.update((k, dft[k]) for k in DENSE_PER_FORCE)
    return launches, dict(solver=solver, dslots=dslots, vslots=vslots,
                          valid=valid)


def clustered_superstep(solver, dslots, vslots, valid, fft):
    """bench.py's timed superstep on a binned state: two KDK steps of
    two forces each (SUPERSTEP_STEPS, FastPM factors in f32), then the
    rebase with velocities at the same K; returns (dslots, vslots,
    valid, overflow)"""
    from pmesh_tpu_torch.models.fastpm import FastPM, leapfrog_factors
    from pmesh_tpu_torch.ops import binned as bn
    dev = dslots[0][0].device
    bounds = SUPERSTEP_BOUNDS
    K1, D1, K2 = leapfrog_factors(SUPERSTEP_STEPS, FastPM(solver.cosmology))
    for j in range(len(K1)):
        k1, d1, k2 = (torch.tensor(c[j], dtype=torch.float32, device=dev)
                      for c in (K1, D1, K2))
        F = solver.force_binned(dslots, valid, bounds, fft=fft)
        vslots = tuple(tuple(v + f * k1 for v, f in zip(vk, fk))
                       for vk, fk in zip(vslots, F))
        dslots = tuple(tuple(s + v * d1 for s, v in zip(dk, vk))
                       for dk, vk in zip(dslots, vslots))
        F = solver.force_binned(dslots, valid, bounds, fft=fft)
        vslots = tuple(tuple(v + f * k2 for v, f in zip(vk, fk))
                       for vk, fk in zip(vslots, F))
        del F
    dslots, valid, (vslots,), ov = bn.rebase(dslots, valid, bounds,
                                             extras=(vslots,))
    return dslots, vslots, valid, ov


# kernel-name fragment -> family for the profile, first match wins
FAMILIES = (
    ("readout_staged", "readout_lattice"),
    ("paint_staged", "paint_lattice"),
    ("assign_staged", "rebase_assign"),
    ("rebase_apply", "rebase_apply"),
    ("tc_gemm", "DFT products: tensor cores (tc_gemm)"),
    ("split_", "DFT split passes"),
    ("ct_fwd_col0", "DFT column-0 chains"),
    ("tc_ct", "DFT products: ct2, tensor cores (tc_ct, tc_z)"),
    ("tc_z", "DFT products: ct2, tensor cores (tc_ct, tc_z)"),
    ("ct_inv_butterfly", "DFT sweeps"),
    ("zct_combine", "DFT sweeps"),
    ("nyquist_rowsum", "DFT sweeps"),
    ("fft", "cuFFT"),
    ("gemm", "cuBLAS"),
    ("reduce", "reductions"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
    ("elementwise", "elementwise"),
)


def family(name):
    for frag, fam in FAMILIES:
        if frag.lower() in name.lower():
            return fam
    return "other"


def busy_us(intervals):
    """length of the union of (start, end) intervals"""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_superstep(solver, dslots, vslots, valid, fft):
    """one warm superstep under torch.profiler: the host wall time, the
    device busy time (the union of the kernel and copy intervals), the
    idle share 1 - busy / wall and the device time of each kernel family
    (CUDA events only: the aten rows would count their kernels twice)"""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = clustered_superstep(solver, dslots, vslots, valid, fft)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if int(out[3]) != 0:
        raise AssertionError("the profiled superstep overflowed")
    del out
    fams, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        fams[family(e.name)] = fams.get(family(e.name), 0.0) + (b - a) / 1e3
    if not spans:
        raise AssertionError("the profiler recorded no device event")
    busy = busy_us(spans) / 1e3
    log("phase 5 profile: %d^3 K=%d one superstep fft=%r: wall %.3f ms, "
        "device busy %.3f ms, idle %.4f"
        % (NC, len(dslots), fft, wall_ms, busy, 1.0 - busy / wall_ms))
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("  %-34s %10.3f ms  %5.1f %%" % (fam, ms, 100.0 * ms / busy))


def phase_clustered_timed(state):
    """on the grown clustered state: force_binned with fft='mxu' held
    against fft='xla', then one KDK step of bench.py's superstep (two
    KDK steps of two forces each, then the rebase with velocities) at
    the grown K with each FFT, the peak memory, and one superstep per
    FFT under the profiler"""
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    solver = state.pop('solver')
    dslots, vslots, valid = (state.pop(k) for k in ('dslots', 'vslots',
                                                    'valid'))
    K = len(dslots)
    bounds = SUPERSTEP_BOUNDS
    Fm = solver.force_binned(dslots, valid, bounds, fft='mxu')
    Fx = solver.force_binned(dslots, valid, bounds, fft='xla')
    err = scale = 0.0
    for fm_k, fx_k, v in zip(Fm, Fx, valid):
        m = v > 0
        for a, b in zip(fm_k, fx_k):
            err = max(err, float((a - b)[m].abs().max()))
            scale = max(scale, float(b[m].abs().max()))
    del Fx
    rel = err / scale
    log("phase 5 clustered force: K=%d force_binned fft='mxu' against "
        "fft='xla' max|dF|/max|F| = %.3e (tol %.0e) %s"
        % (K, rel, TOL_SMALL, "ok" if rel <= TOL_SMALL else "FAIL"))
    if not rel <= TOL_SMALL:
        raise AssertionError("the clustered mxu and xla forces disagree")

    # one force with bf16 products: the dense kernels' bf16 form alone
    torch.cuda.synchronize()
    fft_mxu_cuda.reset_launches()
    Fb = solver.force_binned(dslots, valid, bounds, fft='mxu_bf16')
    torch.cuda.synchronize()
    bf_launches = dict(fft_mxu_cuda.LAUNCHES)
    need = {k + "_bf16": c for k, c in DENSE_PER_FORCE.items()}
    others = {k: v for k, v in bf_launches.items() if v and k not in need}
    num = den = 0.0
    finite = True
    for fb_k, fm_k, v in zip(Fb, Fm, valid):
        m = v > 0
        for a, b in zip(fb_k, fm_k):
            finite = finite and bool(torch.isfinite(a[m]).all())
            num += float(((a - b)[m].double() ** 2).sum())
            den += float((b[m].double() ** 2).sum())
    del Fm, Fb
    rel = (num / den) ** 0.5
    t_bf = cuda_ms(lambda: solver.force_binned(dslots, valid, bounds,
                                               fft='mxu_bf16'), 3)
    t_mxu = cuda_ms(lambda: solver.force_binned(dslots, valid, bounds,
                                                fft='mxu'), 3)
    ok = finite and rel < TOL_BF16_SANITY
    log("phase 5 clustered force, fft='mxu_bf16': K=%d against fft='mxu' "
        "rms|dF|/rms|F| = %.3e (sanity bound %.0e), finite %s, launches %s "
        "(need %s, others %s) %s; force_binned %.3f ms (mxu %.3f)"
        % (K, rel, TOL_BF16_SANITY, finite,
           json.dumps({k: bf_launches[k] for k in need}), json.dumps(need),
           json.dumps(others), "ok" if ok else "FAIL", t_bf, t_mxu))
    if not ok:
        raise AssertionError("the clustered bf16 force is not finite or "
                             "far from fft='mxu'")
    if any(bf_launches[k] != need[k] for k in need) or others:
        raise AssertionError("the dense bf16 kernels did not carry the "
                             "clustered force")

    # every superstep starts from the grown state: the flow keeps
    # compressing, and a chain of supersteps at a fixed K overflows
    # within two
    ms, peak, ovs = {}, {}, []
    for fft in ('mxu', 'xla', 'xla', 'mxu'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for rep in range(3):      # a warm-up, then two timed
            if rep == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            ovs.append(clustered_superstep(solver, dslots, vslots, valid,
                                           fft)[3])
        torch.cuda.synchronize()
        # per KDK step: 2 per superstep, 2 supersteps
        ms.setdefault(fft, []).append((time.perf_counter() - t0) / 4 * 1e3)
        peak[fft] = torch.cuda.max_memory_allocated() / 2 ** 30
    ov = int(sum(int(o) for o in ovs))
    log("phase 5 clustered superstep: %d^3 K=%d bounds %s, ms per KDK step "
        "(bench.py's ms_per_step: two KDK steps of two forces and a rebase"
        " per superstep) fft='mxu' %s, fft='xla' %s (runs in the order "
        "mxu, xla, xla, mxu), peak %.2f GB (mxu) %.2f GB (xla), overflow %d"
        % (NC, K, bounds, ", ".join("%.3f" % t for t in ms['mxu']),
           ", ".join("%.3f" % t for t in ms['xla']), peak['mxu'],
           peak['xla'], ov))
    if ov != 0:
        raise AssertionError("the clustered superstep overflowed")
    for fft in ('mxu', 'xla'):
        profile_superstep(solver, dslots, vslots, valid, fft)
    del dslots, vslots, valid
    torch.cuda.empty_cache()
    return bf_launches


def phase_binned_timed(dev, n=N):
    """one superstep (2 KDK steps + 1 rebase) at n^3, K = 2, occupancy 1:
    the difference of a 4-step and a 2-step nbody_binned run"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    pm = ParticleMesh([n] * 3, BoxSize=float(n), dtype='f4',
                      resampler='cic', device=dev)
    solver = Solver(pm)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    shape = (n,) * 3
    disp = tuple(0.05 + 0.9 * torch.rand(shape, generator=gen, device=dev)
                 for _ in range(3))
    vel = tuple(0.02 * torch.randn(shape, generator=gen, device=dev)
                for _ in range(3))
    steps = [0.5, 0.55, 0.6, 0.65, 0.7]

    def run(nst):
        return lambda: solver.nbody_binned(disp, vel, steps[:nst + 1],
                                           **BINNED_KW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t2 = cuda_ms(run(2), 1)
    t4 = cuda_ms(run(4), 1)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    dslots, vslots, valid, overflow = run(4)()
    ok = (int(overflow) == 0 and int(bn.occupancy(valid)[0]) == n ** 3
          and all(bool(torch.isfinite(x).all())
                  for slot in dslots + vslots for x in slot))
    del dslots, vslots, valid
    dsl, vsl, valid = bn.from_lattice(disp, vel, nslots=2)
    bounds = (-0.5, 1.5)
    f_spec = cuda_ms(lambda: solver.force_binned(dsl, valid, bounds), 3)
    f_grad = cuda_ms(lambda: solver.force_binned(dsl, valid, bounds,
                                                 mode='gradient'), 3)
    t_reb = cuda_ms(lambda: bn.rebase(dsl, valid, bounds, extras=(vsl,)), 3)
    m_spec = cuda_ms(lambda: solver.force_binned(dsl, valid, bounds,
                                                 fft='mxu'), 3)
    m_grad = cuda_ms(lambda: solver.force_binned(dsl, valid, bounds,
                                                 fft='mxu', mode='gradient'),
                     3)
    superstep = t4 - t2
    log("phase 6 binned, timed: %d^3 K=2 occupancy 1 bounds %s: %.3f ms per"
        " KDK step (superstep %.3f ms = 2 KDK + rebase + 1 force; 4-step "
        "run %.3f ms, 2-step run %.3f ms), force_binned spectral %.3f ms, "
        "gradient %.3f ms, rebase with velocities %.3f ms, peak %.2f GB, "
        "overflow 0 and finite: %s"
        % (n, bounds, superstep / 2, superstep, t4, t2, f_spec, f_grad,
           t_reb, peak_gb, ok))
    log("phase 6 binned, fft='mxu': %d^3 K=2 force_binned spectral %.3f ms"
        " (xla %.3f), gradient %.3f ms (xla %.3f)"
        % (n, m_spec, f_spec, m_grad, f_grad))
    if not ok:
        raise AssertionError("the timed binned run overflowed or is not "
                             "finite")
    del solver, disp, vel, dsl, vsl, valid
    torch.cuda.empty_cache()


def phase_small_binned(dev, n=32):
    """32^3 adaptive binned run on the card against the CPU"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    rng = np.random.RandomState(SEED)
    disp = rng.uniform(-0.6, 1.6, (3,) + (n,) * 3).astype('f4')
    vel = (0.3 * rng.normal(size=(3,) + (n,) * 3)).astype('f4')
    out = {}
    for device in ('cpu', dev):
        pm = ParticleMesh([n] * 3, BoxSize=float(n), dtype='f4',
                          resampler='cic', device=device)
        solver = Solver(pm)
        ds, vs, va, ov = solver.nbody_binned(
            tuple(torch.from_numpy(x).to(device) for x in disp),
            tuple(torch.from_numpy(x).to(device) for x in vel),
            np.linspace(0.5, 0.6, 5), nslots=1, rebase_every=2,
            step_drift=0.5, adaptive=True)
        tot, _ = bn.occupancy(va)
        out[str(device)] = (bn.paint_binned(ds, va).cpu().numpy(),
                            int(tot), int(ov), len(ds))
    (ref, rtot, rov, rk), (got, gtot, gov, gk) = out['cpu'], out[str(dev)]
    err = np.abs(got - ref).max() / np.abs(ref).max()
    ok = (np.isfinite(err) and err <= TOL_SMALL and rtot == gtot == n ** 3
          and rov == gov == 0)
    log("phase 7 small input: %d^3 binned adaptive 4 KDK steps, card vs "
        "CPU max|drho|/max|rho| = %.3e (tol %.0e), particles %d / %d, "
        "overflow %d / %d, K %d / %d %s"
        % (n, err, TOL_SMALL, gtot, rtot, gov, rov, gk, rk,
           "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the card and the CPU disagree on the binned "
                             "path at %d^3" % n)


# --- the slab-sharded path: phases 8, 9 and 10 -------------------------------

def flat(out):
    """the tensors of nested tuples, in order"""
    if isinstance(out, (tuple, list)):
        return tuple(t for o in out for t in flat(o))
    return (out,)


def xhalo_case(records, kernel, label, fn, full_fn, reads, ops):
    """an x-halo slab kernel against its plain version (fn(impl)) and
    against the wrapped kernel's rows of the whole mesh (full_fn(), which
    must be bitwise equal: same sums in the same order); the first case
    of each kernel is its record"""
    plain = flat(fn('torch'))
    got = flat(fn('cuda'))
    full = flat(full_fn())
    rel, err = max_rel(got, plain)
    same = bitwise_equal(got, full)
    ms = cuda_ms(lambda: fn('cuda'), 5)
    plain_ms = cuda_ms(lambda: fn('torch'), 1)
    ok = rel <= TOL_KERNEL and np.isfinite(rel) and same
    log("phase 8 compare: %-22s %-34s max|k-p|/max|p| = %.3e (tol %.0e), "
        "bitwise the wrapped kernel's rows: %s %s  kernel %.3f ms  plain "
        "%.3f ms" % (kernel, label, rel, TOL_KERNEL, same,
                     "ok" if ok else "FAIL", ms, plain_ms))
    if not ok:
        raise AssertionError("%s disagrees (%s)" % (kernel, label))
    rec = record(err, ms, plain_ms, nbytes(reads, got), ops)
    log("phase 8 bound: %-22s %-34s %.3f ms by %s, kernel %.3f ms"
        % (kernel, label, rec["bound_ms"], rec["bound_by"], ms))
    if kernel in records:
        records[kernel]["max_abs_err"] = max(records[kernel]["max_abs_err"],
                                             err)
    else:
        records[kernel] = rec


def phase_compare_slab(dev):
    """every slab kernel of the sharded path against its plain version
    at the shapes of RANKS ranks: the x-halo lattice paint and readout
    and the x-halo rebase on a slab of the N^3 main path (the first rank's
    rows, the halo cut with the wrap from the whole mesh, so the result
    is also bitwise the wrapped kernels' rows), the row-9 dense passes at
    the slab and y-chunk shapes of NC^3, and the ct2 passes at those of
    N^3; returns {kernel: record} of the slab forms and row 9"""
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.ops import binned_cuda, gridpm_cuda
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    records = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = N // RANKS
    shape = (N,) * 3

    def halo(t, lo, hi):
        """rows [0, rows) of ``t`` with lo planes below and hi above"""
        return torch.cat([t[N - lo:], t[:rows + hi]], 0) if lo else \
            t[:rows + hi].contiguous()

    lo_b, hi_b = BOUNDS
    vmin, vmax = gp.offset_range(lo_b, hi_b, 'cic')
    disp = tuple(lo_b + (hi_b - lo_b) * torch.rand(shape, generator=gen,
                                                   device=dev)
                 for _ in range(3))
    meshes = tuple(torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
    plo, phi = max(0, vmax), max(0, -vmin)
    dext = tuple(halo(d, plo, phi) for d in disp)
    cells = rows * N * N
    xhalo_case(records, "paint_lattice_xhalo", "%d-row slab of %d^3"
               % (rows, N),
               lambda impl: gridpm_cuda.paint_lattice(
                   dext, None, vmin, vmax, 'cic', rows=rows, xbase=plo)
               if impl == 'cuda' else gp.paint_slab_plain(
                   dext, 1.0, plo, rows, BOUNDS, 'cic'),
               lambda: gridpm_cuda.paint_lattice(disp, None, vmin, vmax,
                                                 'cic')[:rows],
               dext, paint_ops(vmax - vmin + 1, cells))
    rlo, rhi = max(0, -vmin), max(0, vmax)
    mext = tuple(halo(m, rlo, rhi) for m in meshes)
    dslab = tuple(d[:rows] for d in disp)
    # the sharded spectral force's three meshes in one launch (the
    # record), then the gradient force's 'all' of one
    for diffdir, nm in ((None, 3), ('all', 1)):
        xhalo_case(records, "readout_lattice_xhalo",
                   "%d-row slab, %d mesh(es), diffdir=%s"
                   % (rows, nm, diffdir),
                   lambda impl: gridpm_cuda.readout_lattice(
                       mext[:nm], dslab, vmin, vmax, 'cic', diffdir=diffdir,
                       xbase=rlo)
                   if impl == 'cuda' else gp.readout_slab_plain(
                       mext[:nm], dslab, rlo, BOUNDS, 'cic', diffdir),
                   lambda: tuple(o[:rows] for o in gridpm_cuda
                                 .readout_lattice(meshes[:nm], disp, vmin,
                                                  vmax, 'cic',
                                                  diffdir=diffdir)),
                   (mext[:nm], dslab),
                   readout_ops(vmax - vmin + 1, cells, nm,
                               diffdir == 'all'))
    del disp, meshes, dext, mext, dslab
    torch.cuda.empty_cache()

    # the x-halo rebase: the main path's drift bounds, K = 2 -> 2
    bounds, _, kout, _ = REBASE_CASES[0]
    drift = min(0.05 - bounds[0], bounds[1] - 0.95)
    dslots, vslots, valid = rebase_state(dev, gen, N, drift)
    offsets = bn._drift_offsets(bounds, 3)
    olo, ohi = offsets[0][0], offsets[-1][0]
    xlo, xhi = bn._halo_depth(offsets)
    dx = tuple(tuple(halo(t, xlo, xhi) for t in dk) for dk in dslots)
    vx = tuple(halo(t, xlo, xhi) for t in valid)
    ex = tuple(tuple(halo(t, xlo, xhi) for t in vk) for vk in vslots)
    full = binned_cuda.rebase_assign(dslots, valid, kout, olo, ohi)
    full_e = binned_cuda.rebase_apply((vslots,), full[2], olo, ohi)

    def assign(impl):
        if impl == 'cuda':
            return binned_cuda.rebase_assign(dx, vx, kout, olo, ohi,
                                             rows=rows, xbase=xlo)[:3]
        return bn.rebase_assign_plain(dx, vx, offsets, kout, rows=rows,
                                      xbase=xlo)[:3]

    got = binned_cuda.rebase_assign(dx, vx, kout, olo, ohi, rows=rows,
                                    xbase=xlo)
    xhalo_case(records, "rebase_assign_xhalo",
               "%d-row slab, K=2->%d %s" % (rows, kout, bounds), assign,
               lambda: tuple(t[:rows] for t in flat(full[:3])),
               (dx, vx), REBASE_OPS * 2 * cells)
    xhalo_case(records, "rebase_apply_xhalo",
               "%d-row slab, velocities" % rows,
               lambda impl: binned_cuda.rebase_apply(
                   (ex,), got[2], olo, ohi, xbase=xlo)
               if impl == 'cuda' else bn.rebase_apply_plain(
                   (ex,), got[2], offsets, xbase=xlo),
               lambda: tuple(t[:rows] for t in flat(full_e)),
               (ex, got[2]), 0)
    log("phase 8 compare: rebase_assign_xhalo overflow of the slab %d "
        "(the whole mesh %d)" % (int(got[3]), int(full[3])))
    del dslots, vslots, valid, dx, vx, ex, full, full_e, got
    torch.cuda.empty_cache()

    # row 9: the dense passes at the slab and y-chunk shapes of NC^3
    n0, n1 = NC // RANKS, NC // RANKS
    Zh = NC // 2 + 1
    pm = ParticleMesh([NC] * 3, BoxSize=float(NC), dtype='f4', device=dev)
    _, pk2, kd, _ = Solver(pm)._mxu_setup()
    kd = fm._tuples(kd)
    wz = fm._cached(fm._dft_half_np, NC, Zh)
    wyf, wxf = fm._cached(fm._dft_np, NC, -1), fm._cached(fm._dft_np, NC, -1)
    wy, wx = fm._cached(fm._dft_np, NC, +1), fm._cached(fm._dft_np, NC, +1)
    wx_g = fm._cached(fm._dft_fold_np, NC, kd[0])
    AB_p = fm._cached(fm._irfft_mats_np, NC, Zh)
    k2 = fm._cached(fm._sharded_dense_k2, fm._tuples(pk2), NC, NC, Zh, 0,
                    RANKS)
    x = 1.0 + 0.3 * torch.randn((n0, NC, NC), generator=gen, device=dev)

    def case(label, kernel, fn, reads, ops, library=None):
        return dft_case(records, kernel, label, fn, reads, ops, library)
    pr, pi = case("row 9 slab (%d, %d, %d)" % (n0, NC, NC),
                  "zy_fwd_half (row 9)",
                  lambda impl: fm._zy_fwd_dense_call(x, wz, wyf, impl=impl),
                  (x, wz, wyf), zy_ops(n0, NC, NC),
                  lambda: torch.fft.rfftn(x, dim=(1, 2)))
    cr = 0.01 * torch.randn((NC, n1, Zh), generator=gen, device=dev)
    ci = 0.01 * torch.randn((NC, n1, Zh), generator=gen, device=dev)
    for prec in (None, 'bf16'):
        tc_check("zy_fwd_half (row 9) slab %s" % (prec or 'f32'),
                 lambda: fm._zy_fwd_dense_call(x, wz, wyf, precision=prec))
        tc_check("x_dense (row 9) y-chunk dual %s" % (prec or 'f32'),
                 lambda: fm._x_dense_call(cr, ci, wx, 1.0, wx2=wx_g,
                                          k2=k2, precision=prec))
    del x
    zc = torch.complex(cr, ci)
    case("row 9 y-chunk (%d, %d, %d) forward" % (NC, n1, Zh),
         "x_dense (row 9)",
         lambda impl: fm._x_dense_call(cr, ci, wxf, 1.0 / NC ** 3,
                                       impl=impl),
         (cr, ci, wxf), fft_ops(NC, n1 * Zh), lambda: torch.fft.fft(zc, dim=0))
    case("row 9 y-chunk inverse dual, 1/k^2 of chunk 0", "x_dense (row 9)",
         lambda impl: fm._x_dense_call(cr, ci, wx, 1.0, wx2=wx_g, k2=k2,
                                       impl=impl),
         (cr, ci, wx, wx_g, k2), 2 * fft_ops(NC, n1 * Zh),
         library_dual_x(cr, ci, k2))
    del zc
    case("row 9 slab (%d, %d, %d) inverse" % (n0, NC, Zh),
         "zy_inv_half (row 9)",
         lambda impl: fm._zy_inv_dense_call(pr, pi, wy, AB_p, impl=impl),
         (pr, pi, wy, AB_p), zy_ops(n0, NC, NC),
         library_inverse(pr, pi, NC))
    # its bf16 products, by the zy passes' criterion (checked and timed,
    # not a record)
    dft_case({}, "zy_inv_half_bf16 (row 9)",
             "row 9 slab (%d, %d, %d) inverse" % (n0, NC, Zh),
             lambda impl: fm._zy_inv_dense_call(pr, pi, wy, AB_p, impl=impl,
                                                precision='bf16'),
             (pr, pi, wy, AB_p), zy_ops(n0, NC, NC), None,
             (lambda *a: bf16_products_check(*a, tol=TOL_CHAIN),
              lambda impl: fm._zy_inv_dense_call(pr, pi, wy, AB_p,
                                                 impl=impl)), DEFERRED)
    for prec in (None, 'bf16'):
        tc_check("zy_inv_half (row 9) slab %s" % (prec or 'f32'),
                 lambda: fm._zy_inv_dense_call(pr, pi, wy, AB_p,
                                               precision=prec))
    del pr, pi, cr, ci
    torch.cuda.empty_cache()

    # the ct2 passes (rows 5-8) at the slab and y-chunk shapes of N^3:
    # logged; their records stay the whole-mesh ones of phase 3
    logged = {}
    Zm = N // 2
    pm = ParticleMesh([N] * 3, BoxSize=BOX, dtype='f4', device=dev)
    _, pk2, kd, _ = Solver(pm)._mxu_setup()
    wzc = fm._cached(fm._z_fwd_tabs, N, Zm)
    wf, wi = fm._cached(fm._ct_fwd_mats_np, N), fm._cached(
        fm._ct_inv_mats_np, N)
    wxg = fm._cached(fm._ct_inv_mats_np, N, kd[0])
    ABc = fm._cached(fm._z_inv_tabs, N, Zm)
    _, k2c = fm._cached(fm._sharded_ct2_k2, fm._tuples(pk2), N, N, Zm, 0,
                        RANKS)
    x = 1.0 + 0.3 * torch.randn((rows, N, N), generator=gen, device=dev)
    pr, pi, nq = dft_case(logged, "zy_fwd_ct2", "slab (%d, %d, %d)"
                          % (rows, N, N),
                          lambda impl: fm._zy_fwd_ct2_call(x, N, Zm, wzc, wf,
                                                           impl=impl),
                          (x, wzc, wf), zy_ops(rows, N, N))
    del x
    cr = 0.01 * torch.randn((N, rows, Zm), generator=gen, device=dev)
    ci = 0.01 * torch.randn((N, rows, Zm), generator=gen, device=dev)
    dft_case(logged, "xct_multi", "y-chunk (%d, %d, %d) forward"
             % (N, rows, Zm),
             lambda impl: fm._xct_call_multi(cr, ci, wf, 1.0 / N ** 3,
                                             impl=impl),
             (cr, ci, wf), fft_ops(N, rows * Zm))
    dft_case(logged, "xct_multi", "y-chunk inverse dual, 1/k^2 chunk 0",
             lambda impl: fm._xct_call_multi(cr, ci, wi, 1.0, inverse=True,
                                             wx2=wxg, k2=k2c, impl=impl),
             (cr, ci, wi, wxg, k2c), 2 * fft_ops(N, rows * Zm))
    plane = nq / N ** 3
    dft_case(logged, "zy_inv_ct2_dual", "slab, plane rows on A",
             lambda impl: fm._zy_inv_ct2_call_dual(pr, pi, wi, ABc, wi, ABc,
                                                   N, planeA=plane,
                                                   impl=impl),
             (pr, pi, wi, ABc, plane), 2 * zy_ops(rows, N, N))
    del pr, pi, cr, ci, nq, plane
    torch.cuda.empty_cache()
    return records


# --- phase 9: what each rank runs ------------------------------------------
#
# launch.spawn('chip_smoke:card_phases', RANKS, ...) starts RANKS ranks
# that share the card.  Every rank makes the same global inputs from the
# seed on its own device and runs the sharded path on its slab, with the
# launch counters set to 0 just before the run and read just after it;
# the slabs are then gathered to rank 0, which runs the single-device
# path on the same inputs and compares.  Every rank returns its
# counters, rank 0 the comparisons too.

def counters():
    """the launch counters of every CUDA wrapper, one dict"""
    from pmesh_tpu_torch.ops import binned_cuda, fft_mxu_cuda, gridpm_cuda
    out = {}
    for mod in (gridpm_cuda, binned_cuda, fft_mxu_cuda):
        out.update(mod.LAUNCHES)
    return out


def reset_counters():
    from pmesh_tpu_torch.ops import binned_cuda, fft_mxu_cuda, gridpm_cuda
    from pmesh_tpu_torch.parallel import comm
    for mod in (gridpm_cuda, binned_cuda, fft_mxu_cuda):
        mod.reset_launches()
    fft_mxu_cuda.kernel_launches(reset=True)
    comm.reset_staged()


def flat_np(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in flat_np(z)]
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)]


def gathered_rel(got, ref):
    """max over the arrays of max|got - ref| / max|ref|, ``got`` the
    gathered numpy arrays, ``ref`` tensors or arrays"""
    return max(float(np.abs(g.astype(np.float64) - r).max()
                     / np.abs(r).max())
               for g, r in zip(flat_np(got), flat_np(ref)))


def bits_equal(got, ref):
    got, ref = flat_np(got), flat_np(ref)
    return len(got) == len(ref) and all(
        g.dtype == r.dtype and g.shape == r.shape
        and g.tobytes() == r.tobytes() for g, r in zip(got, ref))


def timed_run(pm, fn):
    """(fn(), seconds, launches): the counters set to 0 and every rank
    started together just before fn, the clock stopped when the slowest
    rank has synchronised its card, the counters read just after (the
    DFT entry points' device kernels by kind too)"""
    import torch.distributed as dist
    from pmesh_tpu_torch.ops import fft_mxu_cuda
    from pmesh_tpu_torch.parallel.comm import STAGED_BYTES
    torch.cuda.synchronize(pm.device)
    dist.barrier()
    reset_counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(pm.device)
    dist.barrier()
    sec = time.perf_counter() - t0
    return out, dict(seconds=sec, launches=counters(),
                     kinds=fft_mxu_cuda.kernel_launches(reset=True),
                     staged=dict(STAGED_BYTES))


def card_lattice(pm):
    """the sharded lattice path at N^3: for fft='mxu' and 'xla',
    lpt_lattice(order=2) and nbody_lattice over SHARDED_STEPS; then one
    'mxu_bf16s' force of the LPT state.  Rank 0 holds the force of the
    LPT state and the paint of the final state against the single-device
    kernels on the same (gathered) inputs, and the final state against
    the single-device run from the same linear field."""
    from pmesh_tpu_torch import ComplexField, ParticleMesh
    from pmesh_tpu_torch import convert
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import gridpm as gp
    gen = torch.Generator(device=pm.device).manual_seed(SEED)
    pm1 = ParticleMesh([N] * 3, BOX, dtype='f4', device=pm.device)
    dl1 = linear_field(pm1, gen)
    solver = Solver(ParticleMesh([N] * 3, BOX, dtype='f4', procmesh=pm))
    dk = solver.pm.create(type=ComplexField, value=convert.to_slabs(
        dl1.value, pm, axis=1))
    if pm.rank:
        del dl1
    s1 = Solver(pm1) if pm.rank == 0 else None

    def on_card(arrays):
        return tuple(torch.from_numpy(a).to(pm.device) for a in arrays)

    out = {}
    for fft in SHARDED_FFTS + (SHARDED_EXTRA_FORCE,):
        if fft == SHARDED_EXTRA_FORCE:
            disp, _ = solver.lpt_lattice(dk, A0, order=2)
            F, rec = timed_run(pm, lambda: solver.force_lattice(
                disp, BOUNDS, fft=fft))
            parts = (disp, F)
        else:
            def run():
                d, v = solver.lpt_lattice(dk, A0, order=2)
                S, V = solver.nbody_lattice(d, v, SHARDED_STEPS, BOUNDS,
                                            fft=fft)
                return d, S, V
            (disp, S, V), rec = timed_run(pm, run)
            F = solver.force_lattice(disp, BOUNDS, fft=fft)
            rho = gp.paint_grid(S, bounds=BOUNDS, procmesh=pm)
            parts = (disp, F, S, rho, V)
            del S, V, rho
        got = convert.gather(parts, pm, dst=0)
        del disp, F, parts
        if pm.rank == 0:
            rec['finite'] = all(np.isfinite(a).all() for a in flat_np(got))
            rec['force'] = gathered_rel(got[1], s1.force_lattice(
                on_card(got[0]), BOUNDS, fft=fft))
            if fft != SHARDED_EXTRA_FORCE:
                rec['paint'] = gathered_rel(got[3], gp.paint_grid(
                    on_card(got[2]), bounds=BOUNDS))
                d1, v1 = s1.lpt_lattice(dl1, A0, order=2)
                S1, V1 = s1.nbody_lattice(d1, v1, SHARDED_STEPS, BOUNDS,
                                          fft=fft)
                rec['state'] = gathered_rel((got[2], got[4]), (S1, V1))
                del d1, v1, S1, V1
            torch.cuda.empty_cache()
        del got
        out[fft] = rec
    return out


def card_dense(pm):
    """the sharded force_lattice(fft='mxu') at a dense NC^3 (kernel-table
    row 9) from seeded displacements in [0.05, 0.95); rank 0 holds the
    forces against the single-device force"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch import convert
    from pmesh_tpu_torch.models.fastpm import Solver
    gen = torch.Generator(device=pm.device).manual_seed(SEED + 8)
    full = tuple(0.05 + 0.9 * torch.rand((NC,) * 3, generator=gen,
                                         device=pm.device)
                 for _ in range(3))
    disp = convert.to_slabs(full, pm)
    if pm.rank:
        del full
    solver = Solver(ParticleMesh([NC] * 3, float(NC), dtype='f4',
                                 procmesh=pm))
    solver.force_lattice(disp, DENSE_BOUNDS, fft='mxu')   # tables, warm-up
    F, rec = timed_run(pm, lambda: solver.force_lattice(
        disp, DENSE_BOUNDS, fft='mxu'))
    got = convert.gather(F, pm, dst=0)
    if pm.rank == 0:
        s1 = Solver(ParticleMesh([NC] * 3, float(NC), dtype='f4',
                                 device=pm.device))
        rec['force'] = gathered_rel(got, s1.force_lattice(
            full, DENSE_BOUNDS, fft='mxu'))
        del s1
        torch.cuda.empty_cache()
    return rec


def card_binned(pm):
    """the sharded binned path at N^3, K = 2: one sharded rebase of a
    seeded K = 2 state (rank 0: bitwise against the single-device rebase,
    the overflow equal) and a superstep of nbody_binned from a seeded
    lattice state (rank 0: the density against the single-device run's;
    every rank: the global particle count and overflow)"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch import convert
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.parallel.comm import all_reduce
    dev = pm.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    shape = (N,) * 3
    bounds = REBASE_CASES[0][0]

    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
    drift = min(0.05 - bounds[0], bounds[1] - 0.95)
    dslots = tuple(tuple(uni(0.05, 0.95) + uni(-drift, drift)
                         for _ in range(3)) for _ in range(2))
    valid = (torch.ones(shape, device=dev), (uni(0.0, 1.0) < 0.25).float())
    vslots = tuple(tuple(0.02 * torch.randn(shape, generator=gen, device=dev)
                         for _ in range(3)) for _ in range(2))
    local = convert.to_slabs((dslots, valid, vslots), pm)
    if pm.rank:
        del dslots, valid, vslots
    out, reb = timed_run(pm, lambda: bn.rebase(
        local[0], local[1], bounds, extras=(local[2],), procmesh=pm))
    reb['overflow'] = int(out[3])
    got = convert.gather(out[:3], pm, dst=0)
    del out, local
    if pm.rank == 0:
        ref = bn.rebase(dslots, valid, bounds, extras=(vslots,))
        reb['bitwise'] = bits_equal(got, ref[:3])
        reb['overflow_single'] = int(ref[3])
        del ref, dslots, valid, vslots
    del got
    torch.cuda.empty_cache()

    disp = tuple(0.05 + 0.9 * torch.rand(shape, generator=gen, device=dev)
                 for _ in range(3))
    vel = tuple(0.02 * torch.randn(shape, generator=gen, device=dev)
                for _ in range(3))
    ld, lv = convert.to_slabs((disp, vel), pm)
    if pm.rank:
        del disp, vel
    solver = Solver(ParticleMesh([N] * 3, float(N), dtype='f4',
                                 procmesh=pm))
    (ds, vs, va, ov), sup = timed_run(pm, lambda: solver.nbody_binned(
        ld, lv, SUPERSTEP_STEPS, **BINNED_KW))
    rho = bn.paint_binned(ds, va, bounds=(-1.0, 2.0), procmesh=pm)
    sup.update(overflow=int(ov), nslots=len(ds), count=int(all_reduce(
        sum(bn._icount(v) for v in va), pm, 'sum')))
    got = convert.gather(rho, pm, dst=0)
    del ds, vs, va, ld, lv, rho
    if pm.rank == 0:
        s1 = Solver(ParticleMesh([N] * 3, float(N), dtype='f4', device=dev))
        d1, _, va1, ov1 = s1.nbody_binned(disp, vel, SUPERSTEP_STEPS,
                                          **BINNED_KW)
        sup['density'] = gathered_rel(
            got, bn.paint_binned(d1, va1, bounds=(-1.0, 2.0)))
        sup['overflow_single'] = int(ov1)
        del s1, d1, va1
    torch.cuda.empty_cache()
    return dict(rebase=reb, superstep=sup)


def card_phases(pm):
    """the three card phases of phase 9 in one job (one start of the
    ranks)"""
    out = {}
    for name, fn in (('lattice', card_lattice), ('dense', card_dense),
                     ('binned', card_binned)):
        out[name] = fn(pm)
        torch.cuda.empty_cache()
    return out


def sharded_need():
    """{run: {kernel: launches summed over the ranks}} that each phase-9
    run must show exactly: per force one x-halo paint and one x-halo
    readout of the three meshes per slot, and MXU_PER_FORCE's or
    DENSE_PER_FORCE's DFT passes; per rebase one x-halo assign and one
    apply"""
    def force(n, dft=None, slots=1):
        need = {"paint_lattice_xhalo": n * slots,
                "readout_lattice_xhalo": n * slots}
        need.update((k, n * v) for k, v in (dft or {}).items())
        return {k: RANKS * v for k, v in need.items()}
    forces = len(SHARDED_STEPS)
    sp = {k: v[0] for k, v in MXU_PER_FORCE.items()}
    # the superstep: the initial fold's rebase and one at its end, a
    # force before the first step and after each
    nreb = 1 + (len(SUPERSTEP_STEPS) - 1) // BINNED_KW['rebase_every']
    binned = force(len(SUPERSTEP_STEPS), slots=BINNED_KW['nslots'])
    binned.update(rebase_assign_xhalo=RANKS * nreb,
                  rebase_apply_xhalo=RANKS * nreb)
    return {'mxu': force(forces, sp), 'xla': force(forces),
            SHARDED_EXTRA_FORCE: force(1, {bf16_name(k, "_bf16s"): v
                                           for k, v in sp.items()}),
            'dense': force(1, DENSE_PER_FORCE),
            'rebase': {"rebase_assign_xhalo": RANKS,
                       "rebase_apply_xhalo": RANKS},
            'superstep': binned}


def phase_sharded(dev):
    """RANKS ranks on the card over gloo (one card: NCCL refuses two
    ranks on one GPU, so the collectives are staged through the host and
    their times are no multi-GPU figure): the ct2 lattice path at N^3
    with fft='mxu' and 'xla' (SHARDED_STEPS) and one 'mxu_bf16s' force,
    the dense force at NC^3 (row 9) and a binned superstep and rebase at
    N^3 (row 12), each held against the single-device kernels on the
    card, and each run's launches, summed over the ranks, against
    sharded_need() exactly; returns those launches by run"""
    from pmesh_tpu_torch.parallel import launch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = launch.spawn('chip_smoke:card_phases', RANKS, 'gloo', dev.type)
    wall = time.perf_counter() - t0
    r0 = out[0]
    need = sharded_need()

    def summed(get):
        tot = {}
        for r in out:
            for k, v in get(r).items():
                tot[k] = tot.get(k, 0) + v
        return tot

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    fails = []
    runs = {}

    def check(run, get, ok, text):
        launches = nonzero(summed(lambda r: get(r)['launches']))
        kinds = nonzero(summed(lambda r: get(r)['kinds']))
        runs[run] = launches
        # the DFT passes of every fft='mxu' mode on tc_gemm, tc_ct, tc_z
        exact = launches == need[run] and not off_tensor_cores(kinds)
        log("%s, staged %s bytes, launches %s (need exactly %s), device "
            "kernels by kind %s (tensor cores only) %s"
            % (text, json.dumps(summed(lambda r: get(r)['staged'])),
               json.dumps(launches), json.dumps(need[run]),
               json.dumps(kinds), "ok" if ok and exact else "FAIL"))
        if not (ok and exact):
            fails.append(run)

    for fft in SHARDED_FFTS + (SHARDED_EXTRA_FORCE,):
        rec = r0['lattice'][fft]
        ok = (rec['finite'] and rec['force'] <= TOL_KERNEL
              and rec.get('paint', 0.0) <= TOL_KERNEL
              and rec.get('state', 0.0) <= TOL_SMALL)
        check(fft, lambda r: r['lattice'][fft], ok,
              "phase 9 sharded: %d ranks, %d^3 %s: %s %.3f s, force of the "
              "LPT state max|d|/max = %.3e, paint of the final state %s, "
              "final (S, V) %s (tol %.0e / %.0e)"
              % (RANKS, N, fft, "force" if fft == SHARDED_EXTRA_FORCE else
                 "lpt_lattice + %d KDK steps" % (len(SHARDED_STEPS) - 1),
                 rec['seconds'], rec['force'],
                 "%.3e" % rec['paint'] if 'paint' in rec else "-",
                 "%.3e" % rec['state'] if 'state' in rec else "-",
                 TOL_KERNEL, TOL_SMALL))
    rec = r0['dense']
    check('dense', lambda r: r['dense'], rec['force'] <= TOL_KERNEL,
          "phase 9 sharded: %d ranks, %d^3 force_lattice(fft='mxu') (row 9) "
          "%.3f s, max|d|/max = %.3e (tol %.0e)"
          % (RANKS, NC, rec['seconds'], rec['force'], TOL_KERNEL))
    reb, sup = r0['binned']['rebase'], r0['binned']['superstep']
    check('rebase', lambda r: r['binned']['rebase'],
          reb['bitwise'] and reb['overflow'] == reb['overflow_single'],
          "phase 9 sharded: %d ranks, %d^3 K=2 rebase %s: bitwise the "
          "single-device rebase %s, overflow %d (single device %d), %.3f s"
          % (RANKS, N, REBASE_CASES[0][0], reb['bitwise'], reb['overflow'],
             reb['overflow_single'], reb['seconds']))
    # the single-device loop folds its lattice state by sort, which
    # rounds each displacement to the f32 spacing of its cell coordinate
    # (3e-5 at 512); the sharded loop folds by rebase, exactly
    check('superstep', lambda r: r['binned']['superstep'],
          sup['overflow'] == sup['overflow_single'] == 0
          and sup['count'] == N ** 3 and sup['density'] <= TOL_SMALL,
          "phase 9 sharded: %d ranks, %d^3 K=2 nbody_binned superstep "
          "%.3f s: particles %d, overflow %d, density max|d|/max = %.3e "
          "(tol %.0e)" % (RANKS, N, sup['seconds'], sup['count'],
                          sup['overflow'], sup['density'], TOL_SMALL))
    log("phase 9 sharded: the job took %.3f s (ranks started, built "
        "inputs, ran, compared)" % wall)
    if fails:
        raise AssertionError("the sharded runs disagree with the "
                             "single-device runs or miss their launches: "
                             "%s" % ", ".join(fails))
    return runs


def phase_pipe_chain(dev):
    """the per-rank chain of the 8-rank 1024^3 sharded force step at its
    CHAIN_SLAB shapes, as bench.py's measure_pipe_chain: the x-halo paint,
    the ct2 zy forward, the dual inverse x pass with 1/k^2 on the y-chunk,
    the dual and single zy inverses and the x-halo readout of the three
    force meshes (the transposes stand in for the all_to_alls), each
    kernel timed alone
    with its bound, beside torch.fft's calls for the same transforms"""
    from pmesh_tpu_torch.ops import fft_mxu as fm
    from pmesh_tpu_torch.ops import gridpm_cuda
    rows, N1, N2 = CHAIN_SLAB
    N0 = rows * CHAIN_RANKS
    Zm = N2 // 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    vmin, vmax = 0, 2       # bench.py's window: displacements in (0, 2)
    disp = tuple(0.05 + 1.9 * torch.rand((rows + vmax, N1, N2),
                                         generator=gen, device=dev)
                 for _ in range(3))
    w = np.fft.fftfreq(N0) * 2 * np.pi
    kd = [tuple((1 / 6 * (8 * np.sin(w) - np.sin(2 * w))).tolist())]
    w = np.fft.fftfreq(N1) * 2 * np.pi
    kd.append(tuple((1 / 6 * (8 * np.sin(w) - np.sin(2 * w))).tolist()))
    w = np.fft.rfftfreq(N2) * 2 * np.pi
    kd.append(tuple((1 / 6 * (8 * np.sin(w) - np.sin(2 * w))).tolist()))
    wz = fm._cached(fm._z_fwd_tabs, N2, Zm)
    wyf = fm._cached(fm._ct_fwd_mats_np, N1)
    wxi = fm._cached(fm._ct_inv_mats_np, N0)
    wxg = fm._cached(fm._ct_inv_mats_np, N0, kd[0])
    wyi = fm._cached(fm._ct_inv_mats_np, N1)
    wyg = fm._cached(fm._ct_inv_mats_np, N1, kd[1])
    ABp = fm._cached(fm._z_inv_tabs, N2, Zm)
    ABg = fm._cached(fm._z_inv_tabs, N2, Zm, kd[2])
    k2t = (np.arange(N0, dtype=np.float32) + 1.0,
           np.arange(N1 // CHAIN_RANKS, dtype=np.float32) + 1.0,
           np.arange(Zm, dtype=np.float32) + 1.0)
    steps = []

    def step(name, fn, reads, ops):
        out = fn()
        ms = cuda_ms(fn, 3)
        rec = record(0.0, ms, None, nbytes(reads, out), ops)
        steps.append((name, ms, rec["bound_ms"]))
        return out
    dslab = tuple(d[vmax:] for d in disp)
    rho = step("paint_lattice_xhalo", lambda: gridpm_cuda.paint_lattice(
        disp, None, vmin, vmax, 'cic', rows=rows, xbase=vmax), disp,
        paint_ops(vmax - vmin + 1, rows * N1 * N2))
    pr, pi, nq = step("zy_fwd_ct2", lambda: fm._zy_fwd_ct2_call(
        rho, N2, Zm, wz, wyf), (rho, wz, wyf), zy_ops(rows, N1, N2))
    # the y-chunk of the transposed spectrum: (N0, N1 / 8, Zm)
    tr = pr[:, :N1 // CHAIN_RANKS].repeat(CHAIN_RANKS, 1, 1)
    ti = pi[:, :N1 // CHAIN_RANKS].repeat(CHAIN_RANKS, 1, 1)
    del pr, pi
    sr, si, gr, gi = step("xct_multi", lambda: fm._xct_call_multi(
        tr, ti, wxi, 1.0, inverse=True, wx2=wxg, k2=k2t),
        (tr, ti, wxi, wxg, k2t), 2 * fft_ops(N0, N1 // CHAIN_RANKS * Zm))
    del tr, ti
    # the all_to_all back moves (N0, N1 / 8, Zm) to (rows, N1, Zm): a
    # reshape of the same bytes stands in for it
    sr, si, gr, gi = (t.reshape(rows, N1, Zm) for t in (sr, si, gr, gi))
    fy, fz = step("zy_inv_ct2_dual", lambda: fm._zy_inv_ct2_call_dual(
        sr, si, wyg, ABp, wyi, ABg, N2), (sr, si, wyg, ABp, wyi, ABg),
        2 * zy_ops(rows, N1, N2))
    fx = step("zy_inv_ct2", lambda: fm._zy_inv_ct2_call(gr, gi, wyi, ABp, N2),
              (gr, gi, wyi, ABp), zy_ops(rows, N1, N2))
    del sr, si, gr, gi
    forces = tuple(torch.cat([f, f[:vmax]], 0) for f in (fx, fy, fz))
    del fx, fy, fz
    step("readout_lattice_xhalo", lambda: gridpm_cuda.readout_lattice(
        forces, dslab, vmin, vmax, 'cic', xbase=0), (forces, dslab),
        readout_ops(vmax - vmin + 1, rows * N1 * N2, 3))
    del forces, disp, dslab
    torch.cuda.empty_cache()
    # torch.fft's calls for the same transforms, each timed alone
    lib = {}
    lib["rfft2 of the slab"] = cuda_ms(lambda: torch.fft.rfft2(rho), 3)
    spec = torch.fft.rfft2(rho)
    del rho
    chunk = spec[:, :N1 // CHAIN_RANKS].repeat(CHAIN_RANKS, 1, 1)
    stacked = torch.stack([chunk, chunk])
    lib["ifft over x of two y-chunks"] = cuda_ms(
        lambda: torch.fft.ifft(stacked, dim=1), 3)
    del chunk, stacked
    three = torch.stack([spec] * 3)
    del spec
    lib["irfft2 of three slabs"] = cuda_ms(
        lambda: torch.fft.irfft2(three, s=(N1, N2)), 3)
    del three
    torch.cuda.empty_cache()
    total = sum(ms for _, ms, _ in steps)
    bound = sum(b for _, _, b in steps)
    dft = sum(ms for name, ms, _ in steps if "lattice" not in name)
    log("phase 10 pipe chain: the per-rank chain of the %d-rank %d^3 "
        "sharded force at %s slabs: %s; total %.3f ms (bound %.3f ms), the "
        "DFT kernels %.3f ms against torch.fft's %s = %.3f ms"
        % (CHAIN_RANKS, N0, CHAIN_SLAB,
           ", ".join("%s %.3f ms (bound %.3f)" % s for s in steps), total,
           bound, dft, ", ".join("%s %.3f ms" % kv for kv in lib.items()),
           sum(lib.values())))


# --- the catalog FastPM path (phase 11) -------------------------------------
#
# The reference's own configuration of a run (FastPM's examples/nbody.py):
# 256^3 particles in a 512 Mpc/h box, f4, a force mesh of B = 2 (512^3
# CIC), Planck15 with EHPower at its sigma8 (0.8159), gadget white noise
# of seed 42, 2LPT at a = 0.1 and 10 KDK steps to a = 1.
CAT_N, CAT_BOX, CAT_B = 256, 512.0, 2
CAT_STEPS = np.linspace(0.1, 1.0, 11)
CAT_SMALL = 32              # the card-vs-CPU run (3 KDK steps)
CAT_NOISE = 64              # the card-vs-CPU native white noise
TOL_GROWTH = 0.05           # lowest-k P(k) growth against (D1 ratio)^2
TOL_CAT_FORCE = 1e-3        # catalog vs lattice force, of max|F|
CAT_FAMILIES = (
    ("indexFunc", "paint: index_add_"),
    ("index_elementwise", "readout: gather"),
    ("fft", "cuFFT"),
    ("reduce", "reductions"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
    ("elementwise", "elementwise"),
)


def generic_paint_bytes(npart, nmesh):
    """a paint's compulsory bytes: the (N, 3) f32 positions read once,
    the f32 mesh written once (the mass is a scalar)"""
    return npart * 3 * 4 + nmesh * 4


def generic_readout_bytes(npart, nmesh, meshes=3):
    """a readout's: the positions and each mesh read once, each (N,)
    output written once"""
    return npart * 3 * 4 + meshes * (nmesh * 4 + npart * 4)


def generic_ops(npart, support=2, meshes=0):
    """the operations a CIC paint (meshes=0) or readout of ``meshes``
    meshes needs per particle: per axis the scaled position, its floor
    and fraction (4) and support weights (3 each); per stencil offset
    the weight product (2) and the flat index (4), then the accumulate
    (paint: 1) or per mesh a product and an accumulate"""
    per_offset = 6 + (1 if meshes == 0 else 2 * meshes)
    return npart * (3 * (4 + 3 * support) + support ** 3 * per_offset)


def catalog_family(name):
    for frag, fam in CAT_FAMILIES:
        if frag.lower() in name.lower():
            return fam
    return "other"


def profile_catalog_step(solver, state):
    """one warm catalog KDK step under torch.profiler: wall, device busy
    and idle share, device time by kernel family; the paint, readout and
    FFT families must each have run on the card"""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    steps = CAT_STEPS[-2:]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solver.nbody(state, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        fam = catalog_family(e.name)
        fams[fam] = fams.get(fam, 0.0) + (b - a) / 1e3
    if not spans:
        raise AssertionError("the profiler recorded no device event")
    busy = busy_us(spans) / 1e3
    log("phase 11 profile: one catalog KDK step (two forces: nbody's "
        "initial force and the step's) on %s: wall %.3f ms, device busy "
        "%.3f ms, idle %.4f" % (CARD, wall_ms, busy, 1.0 - busy / wall_ms))
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("  %-34s %10.3f ms  %5.1f %%" % (fam, ms, 100.0 * ms / busy))
    for fam in ("paint: index_add_", "readout: gather", "cuFFT"):
        if not fams.get(fam):
            raise AssertionError("the catalog step ran no %s on the card"
                                 % fam)


def phase_catalog(dev):
    """the catalog path at the reference's configuration: linear field,
    2LPT, 10 KDK steps and a gradient-mode force on the final state;
    finiteness, mass, and the growth of the lowest k bins checked; the
    step, paint, three-mesh readout and white-noise fills timed"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    from pmesh_tpu_torch.ops import paint as gpaint
    from pmesh_tpu_torch.ops import power as pw
    from pmesh_tpu_torch.ops import transfer as tf
    pm = ParticleMesh([CAT_N] * 3, BoxSize=CAT_BOX, dtype='f4',
                      resampler='cic', device=dev)
    solver = Solver(pm, Planck15, B=CAT_B)
    fpm = solver.fpm
    npart, nmesh = CAT_N ** 3, int(np.prod(fpm.Nmesh))
    power = EHPower(Planck15)
    nsteps = len(CAT_STEPS) - 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dlinear = solver.linear_field(power, SEED, compat='gadget')
    state0 = solver.lpt(dlinear, CAT_STEPS[0], order=2)
    torch.cuda.synchronize()
    t_ic = time.perf_counter() - t0
    marks, held = [], {}

    def mark(a, state):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        # phase 14's reference: the state after CAT_REF_STEP steps
        if len(marks) == CAT_REF_STEP:
            held['S3'], held['V3'] = state.S.clone(), state.V.clone()
    t0 = time.perf_counter()
    final = solver.nbody(state0, CAT_STEPS, monitor=mark)
    Fg = solver.force(final.X, mode='gradient')
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # one KDK step: the mean over steps 2..10 (the first holds nbody's
    # initial force)
    step_ms = marks[0].elapsed_time(marks[-1]) / (nsteps - 1)

    tensors = (state0.S, state0.V, final.S, final.V, Fg)
    finite = all(bool(torch.isfinite(t).all()) for t in tensors)
    mass = float(fpm.paint(final.X).value.double().sum())
    mass_err = abs(mass - npart) / npart
    k, p_init, nmodes = pw.fftpower(pm.paint(state0.X))
    _, p_final, _ = pw.fftpower(pm.paint(final.X))
    # the three lowest bins that hold modes (bin 0 holds the DC alone)
    low = [i for i in range(len(nmodes)) if float(k[i]) > 0][:3]
    growth = (Planck15.D1(CAT_STEPS[-1]) / Planck15.D1(CAT_STEPS[0])) ** 2
    ratios = [float(p_final[i] / p_init[i]) / growth for i in low]
    smax = float(final.S.abs().max())
    log("phase 11 catalog path on %s: %d^3 particles, %d^3 CIC force mesh "
        "(B=%d), f4, box %.0f Mpc/h; gadget noise seed %d, 2LPT at a=%.2f "
        "(IC %.3f s, first run), %d KDK steps to a=%.2f + 1 gradient force "
        "in %.3f s (first run); finite %s, max|S| %.4f Mpc/h, mass error "
        "%.3e (tol %.0e), peak %.2f GB"
        % (CARD, CAT_N, int(fpm.Nmesh[0]), CAT_B, CAT_BOX, SEED,
           CAT_STEPS[0], t_ic, nsteps, CAT_STEPS[-1], t_run, finite, smax,
           mass_err, TOL_MASS, peak_gb))
    log("phase 11 growth on %s: P_final/P_initial / (D1(%.1f)/D1(%.1f))^2 "
        "= %s at k = %s h/Mpc (%s modes; tol %.2f)"
        % (CARD, CAT_STEPS[-1], CAT_STEPS[0],
           " ".join("%.4f" % r for r in ratios),
           " ".join("%.5f" % float(k[i]) for i in low),
           " ".join("%d" % int(nmodes[i]) for i in low), TOL_GROWTH))
    if not finite:
        raise AssertionError("the catalog state or force is not finite")
    if not mass_err <= TOL_MASS:
        raise AssertionError("the catalog paint does not conserve mass")
    if not all(abs(r - 1.0) <= TOL_GROWTH for r in ratios):
        raise AssertionError("the lowest k bins did not grow as D1^2")
    del Fg, dlinear

    # the parts, on the final state
    X = final.X
    a = fpm.affine
    rho = fpm.paint(X)
    rhok = (rho * (float(nmesh) / npart)).r2c()
    meshes = tuple(rhok.apply(tf.force_transfer(d)).c2r().value
                   for d in range(3))
    del rho, rhok
    paint_ms = cuda_ms(lambda: fpm.paint(X), 5)
    readout_ms = cuda_ms(lambda: gpaint.readout(
        meshes, X, window=fpm.resampler.window, scale=a.scale,
        translate=a.translate, period=a.period), 5)
    del meshes
    force_ms = cuda_ms(lambda: solver.force(X), 3)
    grad_ms = cuda_ms(lambda: solver.force(X, mode='gradient'), 3)
    gadget_ms = cuda_ms(lambda: pm.generate_whitenoise(
        SEED, type='complex', compat='gadget'), 2)
    native_ms = cuda_ms(lambda: pm.generate_whitenoise(
        SEED, type='complex', compat='native'), 3)
    pb = generic_paint_bytes(npart, nmesh)
    rb = generic_readout_bytes(npart, nmesh)
    po, ro = generic_ops(npart), generic_ops(npart, meshes=3)
    paint_bound = max(pb / PEAK_BYTES, po / PEAK_FLOPS) * 1e3
    readout_bound = max(rb / PEAK_BYTES, ro / PEAK_FLOPS) * 1e3
    log("phase 11 timing on %s: %.3f ms per catalog KDK step (CUDA events "
        "over steps 2..%d), force spectral %.3f ms, gradient %.3f ms"
        % (CARD, step_ms, nsteps, force_ms, grad_ms))
    log("phase 11 timing on %s: paint %.3f ms (%d particles onto %d^3; "
        "bound %.3f ms by %s: %.3f GB, %.3f GOP), three-mesh readout "
        "%.3f ms (bound %.3f ms by %s: %.3f GB, %.3f GOP)"
        % (CARD, paint_ms, npart, int(fpm.Nmesh[0]), paint_bound,
           "bytes" if pb / PEAK_BYTES >= po / PEAK_FLOPS else "operations",
           pb / 1e9, po / 1e9, readout_ms, readout_bound,
           "bytes" if rb / PEAK_BYTES >= ro / PEAK_FLOPS else "operations",
           rb / 1e9, ro / 1e9))
    log("phase 11 timing on %s: white noise at %d^3: gadget (host fill and "
        "copy) %.3f ms, native (threefry on the card) %.3f ms"
        % (CARD, CAT_N, gadget_ms, native_ms))
    profile_catalog_step(solver, final)
    # phase 14's references, in ID order (the one-device lattice is C order)
    ref = dict(S0=state0.S.cpu(), V0=state0.V.cpu(), S3=held['S3'].cpu(),
               V3=held['V3'].cpu())
    del final, state0, X, held
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, paint_ms=paint_ms, readout_ms=readout_ms,
                ref=ref)


def phase_catalog_lattice(dev, pm, dlinear):
    """the catalog force on phase 4's 512^3 LPT state (Q + S in box
    units) against force_lattice(fft='xla') on the same state"""
    from pmesh_tpu_torch.models.fastpm import Solver
    solver = Solver(pm)
    disp, _ = solver.lpt_lattice(dlinear, A0, order=2)
    cell = float(pm.BoxSize[0] / pm.Nmesh[0])
    F_lat = solver.force_lattice(disp, BOUNDS, fft='xla')
    X = pm.generate_uniform_particle_grid(shift=0.0)
    X += torch.stack([d.reshape(-1) for d in disp], dim=-1) * cell
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    F = solver.force(X)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    fmax = max(float(f.abs().max()) for f in F_lat)
    gap = max(float((F[:, d] - F_lat[d].reshape(-1)).abs().max())
              for d in range(3)) / fmax
    rms = float(sum(((F[:, d].double() - F_lat[d].reshape(-1)) ** 2).sum()
                    for d in range(3)).sqrt()) / float(
        sum((f.double() ** 2).sum() for f in F_lat).sqrt())
    cat_ms = cuda_ms(lambda: solver.force(X), 1)
    lat_ms = cuda_ms(lambda: solver.force_lattice(disp, BOUNDS, fft='xla'),
                     1)
    log("phase 11 catalog vs lattice on %s: %d^3 LPT state, force(X) "
        "against force_lattice(fft='xla'): max|dF|/max|F| %.3e (tol %.0e), "
        "rms|dF|/rms|F| %.3e; catalog force %.3f ms (peak %.2f GB), lattice "
        "force %.3f ms" % (CARD, int(pm.Nmesh[0]), gap, TOL_CAT_FORCE, rms,
                           cat_ms, peak_gb, lat_ms))
    if not gap <= TOL_CAT_FORCE:
        raise AssertionError("the catalog force disagrees with the lattice "
                             "force at %d^3" % int(pm.Nmesh[0]))
    del F, F_lat, X, disp
    torch.cuda.empty_cache()


def phase_catalog_small(dev, n=CAT_SMALL):
    """a small catalog run, card against CPU, and the native white noise
    at CAT_NOISE^3, card against CPU, bitwise in its uniforms"""
    from pmesh_tpu_torch import ParticleMesh, whitenoise
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    power = EHPower(Planck15)
    steps = np.linspace(0.1, 1.0, 4)
    out = {}
    for device in ('cpu', dev):
        pm = ParticleMesh([n] * 3, BoxSize=2.0 * n, dtype='f4',
                          resampler='cic', device=device)
        solver = Solver(pm, Planck15, B=CAT_B)
        state = solver.lpt(solver.linear_field(power, SEED), steps[0])
        end = solver.nbody(state, steps)
        out[str(device)] = (end.S.cpu(), end.V.cpu())
    (S0, V0), (S1, V1) = out['cpu'], out[str(dev)]
    serr = float((S1 - S0).abs().max() / S0.abs().max())
    verr = float((V1 - V0).abs().max() / V0.abs().max())
    ok = serr <= TOL_SMALL and verr <= TOL_SMALL
    log("phase 11 small catalog run on %s: %d^3 B=%d f4 3 KDK steps, card "
        "vs CPU max|dS|/max|S| %.3e, max|dV|/max|V| %.3e (tol %.0e) %s"
        % (CARD, n, CAT_B, serr, verr, TOL_SMALL, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("the catalog run differs on the card and CPU")
    shape = (CAT_NOISE, CAT_NOISE, CAT_NOISE // 2 + 1)
    nm = (CAT_NOISE,) * 3
    u_cpu = whitenoise.native_uniforms(nm, shape, SEED, 'cpu')
    u_dev = whitenoise.native_uniforms(nm, shape, SEED, dev)
    bits = all(torch.equal(a, b.cpu()) for a, b in zip(u_cpu, u_dev))
    f_cpu = whitenoise.generate_native(nm, shape, SEED, device='cpu')
    f_dev = whitenoise.generate_native(nm, shape, SEED, device=dev).cpu()
    gap = float((f_dev - f_cpu).abs().max())
    log("phase 11 native white noise on %s: %d^3 card vs CPU, uniforms "
        "bitwise %s, field max|d| %.3e (f8 transcendentals)"
        % (CARD, CAT_NOISE, bits, gap))
    if not bits or not gap <= 1e-12:
        raise AssertionError("the native white noise differs on the card")


# --- the applications and the rest of the field core (phase 12) ------------
#
# (a) gravpm's catalog mode at phase 11's configuration, its bigfile
# snapshots at a = 0.5 and 1 read back; (b) its lattice mode with
# fft='mxu' at 512^3 from a = 0.1 to 0.2 (phase 4's range), which runs
# the lattice paint and readout and the four ct2 DFT kernels; (c) the
# field API, the analytic vjp/jvp methods and Klein-Gordon at small
# sizes in f8, card against CPU and against central differences.
APP_SNAPS = [0.5, 1.0]
LAT_BOX = 1024.0            # Mpc/h: 2 Mpc/h cells, widened if nv > NV_MAX
LAT_STEPS = 6               # 5 KDK steps, a = 0.1 .. 0.2
APP_SMALL = 32
TOL_APP = 1e-10             # f8 card vs CPU, of max|CPU|
TOL_FD = 1e-5               # vjp/jvp against central differences


def phase_apps_catalog(dev, ref_step_ms=None):
    """gravpm.run_sim in catalog mode at phase 11's configuration with
    bigfile snapshots, read back with read_ic"""
    import tempfile
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models import gravpm
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.utils.timers import Timers
    nsteps = len(CAT_STEPS) - 1
    timers = Timers()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final, spectra = gravpm.run_sim(
            nmesh=CAT_N, boxsize=CAT_BOX, boost=CAT_B, resampler='cic',
            seed=SEED, ainit=CAT_STEPS[0], afinal=CAT_STEPS[-1],
            steps=len(CAT_STEPS), order=2, unitary=False, compat='gadget',
            dtype='f4', snapshot_times=APP_SNAPS, output=tmp,
            monitor_print=False, device=dev, timers=timers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        snaps = sorted(os.listdir(tmp))
        t0 = time.perf_counter()
        back = [gravpm.read_ic(os.path.join(tmp, s)) for s in snaps]
        from pmesh_tpu_torch.utils import bigfile
        pk = [(bigfile.BigFile(os.path.join(tmp, s))['PowerSpectrum/k']
               .read(), bigfile.BigFile(os.path.join(tmp, s))
               ['PowerSpectrum/P'].read()) for s in snaps]
        t_read = time.perf_counter() - t0
    npart = CAT_N ** 3
    X, V = final.X.cpu().numpy(), final.V.cpu().numpy()
    pos, vel, ids, attrs = back[-1]
    same = (pos.tobytes() == X.tobytes() and vel.tobytes() == V.tobytes()
            and np.array_equal(ids, np.arange(npart)))
    spectra_same = len(pk) == len(spectra) and all(
        k.tobytes() == sk.tobytes() and p.tobytes() == sp.tobytes()
        for (k, p), (_, sk, sp) in zip(pk, spectra))
    times = [float(b[3]['Time']) for b in back]
    finite = all(np.isfinite(b[0]).all() and np.isfinite(b[1]).all()
                 for b in back)
    mass = float(ParticleMesh(
        [CAT_N * CAT_B] * 3, BoxSize=CAT_BOX, dtype='f4', resampler='cic',
        device=dev).paint(final.X).value.double().sum())
    mass_err = abs(mass - npart) / npart
    (a0, k, p0), (a1, _, p1) = spectra
    low = [i for i in range(len(k)) if k[i] > 0][:3]
    growth = (Planck15.D1(a1) / Planck15.D1(a0)) ** 2
    ratios = [float(p1[i] / p0[i]) / growth for i in low]
    rep = timers.report()
    # both snapshots are taken inside the loop, so its stepping alone is
    # the loop's time less theirs: nbody's first force and 10 KDK steps
    step_ms = (rep['nbody'][0] - rep['measure'][0]) / nsteps * 1e3
    log("phase 12 gravpm catalog on %s: run_sim(nmesh=%d, boost=%d, f4, "
        "cic, gadget seed %d, %d steps a=%.2f..%.2f, snapshots %s) in "
        "%.3f s (first run): IC %.3f s, nbody %.3f s with %d snapshots "
        "(%.3f s), %.3f ms per KDK step (nbody less the snapshots, over %d "
        "steps, its initial force included; phase 11 %s ms); peak %.2f GB"
        % (CARD, CAT_N, CAT_B, SEED, len(CAT_STEPS), CAT_STEPS[0],
           CAT_STEPS[-1], APP_SNAPS, wall, rep['ic'][0], rep['nbody'][0],
           rep['measure'][1], rep['measure'][0], step_ms, nsteps,
           "not run" if ref_step_ms is None else "%.3f" % ref_step_ms,
           peak_gb))
    log("phase 12 gravpm catalog snapshots: %s at a = %s, read back in "
        "%.3f s: final Position/Velocity/ID bitwise the state %s, P(k) "
        "blocks bitwise the spectra %s, finite %s, mass error %.3e (tol "
        "%.0e)" % (snaps, times, t_read, same, spectra_same, finite,
                   mass_err, TOL_MASS))
    log("phase 12 gravpm catalog P(k) on %s: a=%.2f %s; a=%.2f %s at k = "
        "%s h/Mpc; P ratio / (D1(%.2f)/D1(%.2f))^2 = %s (tol %.2f)"
        % (CARD, a0, " ".join("%.2f" % p0[i] for i in low), a1,
           " ".join("%.2f" % p1[i] for i in low),
           " ".join("%.5f" % k[i] for i in low), a1, a0,
           " ".join("%.4f" % r for r in ratios), TOL_GROWTH))
    if not (same and spectra_same and finite and len(snaps) == 2
            and times == [a0, a1]):
        raise AssertionError("gravpm's snapshots do not read back as "
                             "written")
    if not mass_err <= TOL_MASS:
        raise AssertionError("gravpm's final state does not conserve mass")
    if not all(abs(r - 1.0) <= TOL_GROWTH for r in ratios):
        raise AssertionError("gravpm's lowest k bins did not grow as D1^2")
    del final
    torch.cuda.empty_cache()
    return step_ms


def lattice_box(dev):
    """the box of the 512^3 lattice run: LAT_BOX, doubled while the
    displacement bounds run_sim will take need more than NV_MAX offsets
    per axis; returns (box, bounds, nv)"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models import gravpm
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops.gridpm_cuda import NV_MAX
    a0, a1 = STEPS[0], STEPS[-1]
    for box in (LAT_BOX, 2 * LAT_BOX):
        # run_sim's defaults: unitary native noise, 2LPT
        pm = ParticleMesh([N] * 3, BoxSize=box, dtype='f4', resampler='cic',
                          device=dev)
        solver = Solver(pm, Planck15)
        dlin = solver.linear_field(EHPower(Planck15, redshift=0.0), SEED,
                                   unitary=True, compat='native')
        disp, _ = solver.lpt_lattice(dlin, a0=a0, order=2)
        lo, hi = (float(b) for b in gp.displacement_bounds(disp))
        bounds = gravpm.lattice_bounds(solver, disp, a0, a1)
        vmin, vmax = gp.offset_range(*bounds, 'cic')
        nv = vmax - vmin + 1
        log("phase 12 gravpm lattice bounds: %d^3 box %.0f Mpc/h, LPT "
            "displacements [%.4f, %.4f] cells at a=%.2f, bounds (%.4f, "
            "%.4f) cells to a=%.2f, CIC offsets per axis %d (NV_MAX %d)"
            % (N, box, lo, hi, a0, bounds[0], bounds[1], a1, nv, NV_MAX))
        del dlin, disp, solver
        if nv <= NV_MAX:
            return box, bounds, nv
    raise AssertionError("the lattice bounds need more than NV_MAX offsets "
                         "even in a %.0f Mpc/h box" % box)


def phase_apps_lattice(dev):
    """gravpm.run_sim in lattice mode with fft='mxu' at 512^3: the
    launch counters set to 0 just before and read just after; then the
    lattice kernels against plain on the run's final state"""
    import warnings
    from pmesh_tpu_torch.models import gravpm
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.utils.timers import Timers
    box, bounds, nv = lattice_box(dev)
    torch.cuda.empty_cache()
    timers = Timers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (S, V), spectra = gravpm.run_sim(
            nmesh=N, boxsize=box, boost=1, resampler='cic', seed=SEED,
            ainit=STEPS[0], afinal=STEPS[-1], steps=LAT_STEPS, order=2,
            dtype='f4', lattice=True, fft='mxu', monitor_print=False,
            device=dev, timers=timers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in counters().items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(bool(torch.isfinite(x).all()) for x in S + V)
    lo, hi = (float(b) for b in gp.displacement_bounds(S))
    rho = gp.paint_grid(S, bounds=bounds)
    mass_err = abs(float(rho.double().sum()) - N ** 3) / N ** 3
    del rho
    rep = timers.report()
    nsteps = LAT_STEPS - 1
    warned = [str(w.message) for w in caught]
    need = ("paint_lattice", "readout_lattice") + tuple(MXU_PER_FORCE)
    log("phase 12 gravpm lattice on %s: run_sim(nmesh=%d, box %.0f Mpc/h, "
        "f4, cic, lattice, fft='mxu', %d KDK steps a=%.2f..%.2f) in %.3f s "
        "(first run): IC %.3f s, nbody %.3f s = %.3f ms per KDK step (its "
        "initial force included), P(k) %.3f s; bounds (%.4f, %.4f) cells, "
        "nv %d; final displacements [%.4f, %.4f] cells, finite %s, mass "
        "error %.3e (tol %.0e), warnings %s, peak %.2f GB; launches %s"
        % (CARD, N, box, nsteps, STEPS[0], STEPS[-1], wall, rep['ic'][0],
           rep['nbody'][0], rep['nbody'][0] / nsteps * 1e3,
           rep['measure'][0], bounds[0], bounds[1], nv, lo, hi, finite,
           mass_err, TOL_MASS, warned, peak_gb, json.dumps(launches)))
    a, k, p = spectra[-1]
    log("phase 12 gravpm lattice P(k) at a=%.2f: %s at k = %s h/Mpc"
        % (a, " ".join("%.2f" % v for v in p[1:4]),
           " ".join("%.5f" % v for v in k[1:4])))
    if not finite or warned:
        raise AssertionError("the lattice run left its bounds or warned")
    if not mass_err <= TOL_MASS:
        raise AssertionError("the lattice paint does not conserve mass")
    if not all(launches.get(name) for name in need):
        raise AssertionError("the lattice run did not launch every kernel "
                             "of its path: %s" % (need,))
    lattice_parity(dev, S, bounds, nv)
    del S, V
    # the first run built the DFT tables and warmed the kernels: time a
    # second run of the same configuration
    timers = Timers()
    (S, V), _ = gravpm.run_sim(
        nmesh=N, boxsize=box, boost=1, resampler='cic', seed=SEED,
        ainit=STEPS[0], afinal=STEPS[-1], steps=LAT_STEPS, order=2,
        dtype='f4', lattice=True, fft='mxu', monitor_print=False,
        device=dev, timers=timers)
    rep = timers.report()
    log("phase 12 gravpm lattice timing on %s: second run, IC %.3f s, "
        "nbody %.3f s = %.3f ms per KDK step (its initial force included), "
        "P(k) %.3f s" % (CARD, rep['ic'][0], rep['nbody'][0],
                         rep['nbody'][0] / nsteps * 1e3, rep['measure'][0]))
    profile_lattice_step(dev, box, S, V, bounds, nv)
    del S, V
    torch.cuda.empty_cache()
    return launches


def lattice_parity(dev, S, bounds, nv):
    """the paint and the three-mesh readout at the lattice run's own
    shape and run-time width: kernel against plain on the run's final
    displacements and bounds, three random meshes read (after the
    counters were read, so these launches are not counted)"""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    meshes = tuple(torch.randn(S[0].shape, generator=gen, device=dev)
                   for _ in range(3))
    cases = lattice_cases(S, meshes, bounds)
    for name in ("paint", "readout 3 meshes"):
        kernel, fn = cases[name]
        t0 = time.perf_counter()
        rel, abs_err = max_rel(fn('cuda'), fn('torch'))
        ok = rel <= TOL_KERNEL and np.isfinite(rel)
        log("phase 12 compare: %-16s %d^3 bounds (%.4f, %.4f) nv=%d (read "
            "at run time) on the lattice run's final state  max|k-p|/max|p|"
            " = %.3e, max|k-p| = %.3e (tol %.0e) %s in %.3f s"
            % (name, S[0].shape[0], bounds[0], bounds[1], nv, rel, abs_err,
               TOL_KERNEL, "ok" if ok else "FAIL", time.perf_counter() - t0))
        if not ok:
            raise AssertionError("%s disagrees with its plain version on "
                                 "the lattice run's state" % kernel)
    del meshes
    torch.cuda.empty_cache()


def profile_lattice_step(dev, box, S, V, bounds, nv):
    """one warm KDK step of the gravpm lattice state under torch.profiler
    (nbody_lattice's initial force and the step's): wall, device busy
    and idle share, device time by kernel family"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    pm = ParticleMesh([N] * 3, BoxSize=box, dtype='f4', resampler='cic',
                      device=dev)
    solver = Solver(pm, Planck15)
    steps = [STEPS[-1], STEPS[-1] + 0.01]
    solver.nbody_lattice(S, V, steps, bounds, fft='mxu')
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solver.nbody_lattice(S, V, steps, bounds, fft='mxu')
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        fam = family(e.name)
        fams[fam] = fams.get(fam, 0.0) + (b - a) / 1e3
    if not spans:
        raise AssertionError("the profiler recorded no device event")
    busy = busy_us(spans) / 1e3
    log("phase 12 profile: one gravpm lattice KDK step (two forces) at "
        "%d^3, nv %d, fft='mxu' on %s: wall %.3f ms, device busy %.3f ms, "
        "idle %.4f" % (N, nv, CARD, wall_ms, busy, 1.0 - busy / wall_ms))
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("  %-46s %10.3f ms  %5.1f %%" % (fam, ms, 100.0 * ms / busy))
    for fam in ("paint_lattice", "readout_lattice"):
        if not fams.get(fam):
            raise AssertionError("the lattice step ran no %s on the card"
                                 % fam)


def field_api_run(device, n=APP_SMALL):
    """the field API's outputs at n^3 f8 on ``device``, from one numpy
    seed: a list of (name, tensor)"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.pm import TransposedComplexField, RealField
    from pmesh_tpu_torch.models import kleingordon as kg
    rng = np.random.RandomState(SEED)
    x = rng.normal(size=(n,) * 3)
    pos = rng.uniform(0, 2.0 * n, (4096, 3))
    mass = rng.uniform(0.5, 1.5, 4096)
    v_pos, v_mass = rng.normal(size=(4096, 3)), rng.normal(size=4096)
    y = rng.normal(size=(n,) * 3)
    t = {k: torch.from_numpy(a).to(device) for k, a in dict(
        x=x, pos=pos, mass=mass, v_pos=v_pos, v_mass=v_mass, y=y).items()}
    pm = ParticleMesh([n] * 3, BoxSize=2.0 * n, device=device)
    real = pm.create(type='real', value=t['x'])
    vf = pm.create(type='real', value=t['y'])
    comp = real.r2c()
    out = []
    for m in (n // 2, 3 * n // 2):
        o = pm.reshape(Nmesh=m).create(type='complex')
        comp.resample(o)
        out.append(("resample to %d^3" % m, o.value))
    out.append(("downsample", pm.reshape(Nmesh=n // 2).downsample(
        real, keep_mean=True).value))
    out.append(("upsample", pm.reshape(Nmesh=2 * n).upsample(
        real, resampler='tsc').value))
    out.append(("preview", torch.from_numpy(
        real.preview(Nmesh=n // 2, axes=(2, 0)))))
    c = comp.copy()
    for ind, val in (([1, 2, 3], 1 + 2j), ([n - 1, 0, 0], 0.5 - 1j),
                     ([0, 0, n // 2], 2.0), ([3, 4, 5, 1], 0.25)):
        c.csetitem(ind, val)
    got = [c.cgetitem(i) for i in ([1, 2, 3], [n - 1, 0, 0], [1, 0, 0],
                                   [3, 4, 5], [n - 3, n - 4, n - 5])]
    out.append(("csetitem", c.value))
    out.append(("cgetitem", torch.tensor(np.asarray(got))))
    c2c = ParticleMesh([n] * 3, BoxSize=2.0 * n, dtype='c16', device=device)
    z = c2c.create(type='real', value=torch.complex(t['x'], t['y']))
    out.append(("c2c r2c", z.r2c().value))
    out.append(("c2c round trip - input", z.r2c().c2r().value - z.value))
    P, M, VP, VM = t['pos'], t['mass'], t['v_pos'], t['v_mass']
    ms, mp = real.readout_vjp(P, VM)
    out += [("readout_vjp self", ms.value), ("readout_vjp pos", mp)]
    pp, pmass = pm.paint_vjp(vf, P, mass=M)
    out += [("paint_vjp pos", pp), ("paint_vjp mass", pmass)]
    out.append(("readout_jvp", real.readout_jvp(P, v_self=vf, v_pos=VP)))
    out.append(("paint_jvp", pm.paint_jvp(P, mass=M, v_pos=VP,
                                          v_mass=VM).value))
    out.append(("c2r_vjp", RealField.c2r_vjp(vf).value))
    out.append(("r2c_vjp", TransposedComplexField.r2c_vjp(comp).value))
    out.append(("cdot_vjp", comp.cdot_vjp(vf.r2c()).value))
    out.append(("decompress_vjp",
                TransposedComplexField.decompress_vjp(comp).value))
    kpm = ParticleMesh([32, 32], BoxSize=32.0, device=device)
    u, du = kg.ring_soliton_ic(kpm)
    out.append(("kleingordon 32^2 x 21 steps", kg.kgsolver(
        np.linspace(0, 1.0, 21), u, du, torch.sin).value))
    return out


def fd_checks(dev, n=APP_SMALL):
    """each vjp/jvp method on the card against central differences of
    the function it differentiates: max|fd - method| / max|method|"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.gradcheck import central_difference
    from pmesh_tpu_torch.pm import TransposedComplexField, RealField
    rng = np.random.RandomState(SEED + 1)
    pm = ParticleMesh([n] * 3, BoxSize=float(n), resampler='tsc',
                      device=dev)

    def T(a):
        return torch.from_numpy(np.asarray(a)).to(dev)
    pos = T(rng.uniform(0, n, (8, 3)))
    mass, v = T(rng.uniform(0.5, 1.5, 8)), T(rng.normal(size=8))
    f = pm.create(type='real', value=T(rng.normal(size=(n,) * 3)))
    g = pm.create(type='real', value=T(rng.normal(size=(n,) * 3)))
    near = np.unique(np.ravel_multi_index(
        np.floor(pos.cpu().numpy()[:2]).astype(int).T % n, (n,) * 3))
    gaps = {}

    def gap(name, fd, ana):
        fd, ana = torch.as_tensor(fd).reshape(-1), \
            torch.as_tensor(ana).detach().cpu().reshape(-1)
        gaps[name] = float((fd - ana).abs().max() / ana.abs().max())

    def field(value, like=f):
        return pm.create(type=type(like), value=value)
    ms, mp = f.readout_vjp(pos, v)
    _, fd = central_difference(lambda p: (f.readout(p) * v).sum(), pos,
                               eps=1e-6)
    gap("readout_vjp pos", fd, mp)
    idx, fd = central_difference(
        lambda m: (field(m).readout(pos) * v).sum(), f.value, eps=1e-6,
        indices=near)
    gap("readout_vjp self", fd, ms.value.reshape(-1)[idx])
    pp, pmass = pm.paint_vjp(g, pos, mass=mass)
    _, fd = central_difference(
        lambda p: (pm.paint(p, mass=mass).value * g.value).sum(), pos,
        eps=1e-6)
    gap("paint_vjp pos", fd, pp)
    _, fd = central_difference(
        lambda m: (pm.paint(pos, mass=m).value * g.value).sum(), mass,
        eps=1e-6)
    gap("paint_vjp mass", fd, pmass)
    vp, vm = T(rng.normal(size=(8, 3))), T(rng.normal(size=8))
    eps = 1e-6
    fd = (pm.paint(pos + eps * vp, mass=mass + eps * vm).value
          - pm.paint(pos - eps * vp, mass=mass - eps * vm).value) / (2 * eps)
    gap("paint_jvp", fd.cpu(), pm.paint_jvp(pos, mass=mass, v_pos=vp,
                                            v_mass=vm).value)
    fd = ((f + eps * g).readout(pos + eps * vp)
          - (f - eps * g).readout(pos - eps * vp)) / (2 * eps)
    gap("readout_jvp", fd.cpu(), f.readout_jvp(pos, v_self=g, v_pos=vp))
    # the linear operators, probed at 48 entries each: r2c_vjp(v) is the
    # gradient of Re cdot(r2c(x), v); c2r_vjp and cdot_vjp, weighted by
    # the hermitian expansion, those of sum(c2r(X) v) and Re cdot(s, o)
    probe = rng.choice(n ** 3 // 2, 48, replace=False)
    vc = g.r2c()
    idx, fd = central_difference(
        lambda x: field(x).r2c().cdot(vc).real, f.value, eps=1e-6,
        indices=probe)
    gap("r2c_vjp", fd, TransposedComplexField.r2c_vjp(vc).value
        .reshape(-1)[idx])

    X = f.r2c()
    w = RealField.c2r_vjp(g)
    w = w.apply(w._expand_hermitian, kind='index').value.reshape(-1)
    _, fd = central_difference(
        lambda z: (pm.create(type='complex', value=z).c2r().value
                   * g.value).sum(), X.value, eps=1e-6, indices=probe)
    gap("c2r_vjp", fd, w[probe])
    w = X.cdot_vjp(1.0)
    w = w.apply(w._expand_hermitian, kind='index').value.reshape(-1)
    _, fd = central_difference(
        lambda z: X.cdot(pm.create(type='complex', value=z)).real,
        vc.value, eps=1e-6, indices=probe)
    gap("cdot_vjp", fd, w[probe])
    return gaps


def phase_apps_small(dev):
    """the field API, the vjp/jvp methods and Klein-Gordon at 32^3 (32^2)
    f8, card against CPU; the vjp/jvp methods against central
    differences on the card"""
    t0 = time.perf_counter()
    card = field_api_run(dev)
    cpu = field_api_run('cpu')
    t_run = time.perf_counter() - t0
    worst = 0.0
    bad = []
    for (name, g), (_, r) in zip(card, cpu):
        g = g.cpu()
        if name.startswith("c2c round trip"):
            err = float(g.abs().max())
        else:
            err = float((g - r).abs().max() / r.abs().max().clamp_min(1e-300))
        worst = max(worst, err)
        if not err <= TOL_APP:
            bad.append("%s %.3e" % (name, err))
    t0 = time.perf_counter()
    gaps = fd_checks(dev)
    t_fd = time.perf_counter() - t0
    log("phase 12 field API on %s: %d^3 f8 (Klein-Gordon 32^2, 21 steps): "
        "%d outputs, card against CPU max rel %.3e (tol %.0e) in %.3f s; "
        "central differences (tsc, f8) max|fd - method|/max|method|: %s "
        "(tol %.0e) in %.3f s"
        % (CARD, APP_SMALL, len(card), worst, TOL_APP, t_run,
           ", ".join("%s %.2e" % kv for kv in gaps.items()), TOL_FD, t_fd))
    if bad:
        raise AssertionError("the field API differs on the card: "
                             + "; ".join(bad))
    if not all(v <= TOL_FD for v in gaps.values()):
        raise AssertionError("a vjp/jvp method disagrees with central "
                             "differences")


# --- reverse mode beyond the lattice (phase 13) -----------------------------
#
# (a) the catalog forward model at phase 11's configuration: the 256^3
# gadget white noise of seed 42 as a real field, shaped as
# Solver.linear_field shapes it, 2LPT at a = 0.1, 2 KDK steps of
# CAT_STEPS, the paint of the final positions on the 512^3 force mesh
# normalized to 1 + delta, and L = sum (rho - 1)^2 differentiated with
# respect to the noise: finite; <grad L, v> for a seeded direction v
# against torch.func.jvp along v (TOL_DIR) and against a central
# difference of L in f8 along v (TOL_DIR_FD); forward and forward +
# backward ms per KDK step (a 2-step minus a 1-step run), the LPT's
# forward + backward, the peak; (b) force_binned at 512^3, K = 2, from
# phase 6's state under autograd, fft='xla' and 'mxu': the gradient of
# sum over the valid slots of F^2 with respect to the slot
# displacements, finite, the lattice kernels (and the ct2 DFT kernels)
# launched forward and backward exactly GRAD_BINNED (and GRAD_MXU) times
# and no other kernel, mxu against xla as phase 4d holds them, ms and
# peak; nbody_binned under autograd raises at the CUDA rebase, which has
# no gradient rule; (c) phase_small_grad: the catalog model's gradient
# and force_binned's at 32^3, card against CPU; (d) the legacy
# package's pipeline at 512^3 with 256^3 particles against the same
# computation through the modern API, and a legacy lanczos paint at
# 64^3, card against CPU.
CAT_GRAD_STEPS = CAT_STEPS[:3]   # 2 KDK steps, a = 0.1 .. 0.28
TOL_DIR = 1e-3       # <grad L, v> (f4) against the f4 jvp, relative
TOL_DIR_FD = 5e-3    # against the f8 central difference, relative
FD_EPS = 1e-3        # the central difference's step along v
# per slot of force_binned: forward, backward, as GRAD_LATTICE per
# lattice force (each slot is painted and read as one lattice)
BINNED_GRAD_K = 2
GRAD_BINNED = {k: (BINNED_GRAD_K * f, BINNED_GRAD_K * b)
               for k, (f, b) in GRAD_LATTICE.items()}
LEGACY_N, LEGACY_NPART = 512, 256     # mesh, particles per axis
LANCZOS_N = 64
TOL_LEGACY = 1e-5


def catalog_linear(solver, power, noise):
    """the white-noise real field ``noise`` shaped as
    Solver.linear_field shapes white noise"""
    from pmesh_tpu_torch import RealField

    def convolve(k, v):
        kmag = k.normp(2) ** 0.5
        return v * (power(kmag) / k.BoxSize.prod()) ** 0.5
    return solver.pm.create(type=RealField, value=noise).r2c().apply(
        convolve)


def catalog_model(solver, power, noise, steps=CAT_GRAD_STEPS):
    """rho on the force mesh, normalized to 1 + delta, after ``steps``
    (2LPT at steps[0], then Solver.nbody) from the white-noise real
    field ``noise``"""
    pm, fpm = solver.pm, solver.fpm
    state = solver.lpt(catalog_linear(solver, power, noise), steps[0],
                       order=2)
    state = solver.nbody(state, steps)
    return fpm.paint(state.X).value * (float(fpm.Nmesh.prod())
                                       / float(pm.Nmesh.prod()))


def catalog_loss(solver, power, noise, steps=CAT_GRAD_STEPS):
    return ((catalog_model(solver, power, noise, steps) - 1) ** 2).sum()


def catalog_setup(dev, n=CAT_N, box=CAT_BOX, dtype='f4'):
    """the Solver of phase 11's configuration at n^3 particles, EHPower,
    and the gadget white noise of SEED as a real field"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    pm = ParticleMesh([n] * 3, BoxSize=box, dtype=dtype, resampler='cic',
                      device=dev)
    noise = pm.generate_whitenoise(SEED, type='real', compat='gadget').value
    return Solver(pm, Planck15, B=CAT_B), EHPower(Planck15), noise


def catalog_grad(solver, power, noise, steps=CAT_GRAD_STEPS):
    x = noise.detach().clone().requires_grad_()
    g, = torch.autograd.grad(catalog_loss(solver, power, x, steps), x)
    return g


def phase_reverse_catalog(dev, n=CAT_N, box=CAT_BOX, refdir=None):
    """13(a): reverse and forward mode through the catalog model at
    phase 11's configuration; the gradient, <grad L, v> and the jvp
    saved in ``refdir`` for phase 16(b)"""
    solver, power, noise = catalog_setup(dev, n, box)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    v = torch.randn(noise.shape, generator=gen, device=dev,
                    dtype=noise.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g = catalog_grad(solver, power, noise)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(g).all())
    dir_rev = float((g.double() * v.double()).sum())
    if refdir is not None:
        np.save(os.path.join(refdir, 'cat_grad.npy'), g.cpu().numpy())
    del g
    _, dir_fwd = torch.func.jvp(
        lambda y: catalog_loss(solver, power, y), (noise,), (v,))
    dir_fwd = float(dir_fwd)
    if refdir is not None:
        np.save(os.path.join(refdir, 'cat_dir.npy'),
                np.array([dir_rev, dir_fwd]))
    # the same function in f8 at full width, central difference along v
    solver8, power8, noise8 = catalog_setup(dev, n, box, 'f8')
    v8 = v.double()
    with torch.no_grad():
        lp = float(catalog_loss(solver8, power8, noise8 + FD_EPS * v8))
        lm = float(catalog_loss(solver8, power8, noise8 - FD_EPS * v8))
    dir_fd = (lp - lm) / (2 * FD_EPS)
    if refdir is not None:
        # phase 16(b)'s f8 references: the gradient and the jvp
        g8 = catalog_grad(solver8, power8, noise8)
        np.save(os.path.join(refdir, 'cat_grad8.npy'), g8.cpu().numpy())
        dir8 = float((g8 * v8).sum())
        del g8
        _, jv8 = torch.func.jvp(
            lambda y: catalog_loss(solver8, power8, y), (noise8,), (v8,))
        np.save(os.path.join(refdir, 'cat_dir8.npy'),
                np.array([dir8, float(jv8)]))
        del jv8
    del solver8, power8, noise8, v8
    gap_fwd = abs(dir_rev - dir_fwd) / abs(dir_fwd)
    gap_fd = abs(dir_rev - dir_fd) / abs(dir_fd)
    t = {}
    for nst in (1, 2):
        steps = CAT_GRAD_STEPS[:nst + 1]
        t['f%d' % nst] = cuda_ms(lambda: catalog_loss(solver, power, noise,
                                                      steps), 1)
        t['b%d' % nst] = cuda_ms(lambda: catalog_grad(solver, power, noise,
                                                      steps), 1)

    def lpt_grad():
        x = noise.detach().clone().requires_grad_()
        s = solver.lpt(catalog_linear(solver, power, x), CAT_GRAD_STEPS[0],
                       order=2)
        return torch.autograd.grad((s.S ** 2 + 2 * s.V ** 2).sum(), x)
    t_lpt = cuda_ms(lpt_grad, 1)
    log("phase 13(a) catalog reverse mode on %s: %d^3 particles, %d^3 CIC "
        "force mesh, f4, d/d(noise) of sum (rho - 1)^2 after 2LPT + %d KDK "
        "steps: finite %s, peak %.2f GB; <grad L, v> %.9e, jvp %.9e (gap "
        "%.3e, tol %.0e), f8 central difference (eps %.0e) %.9e (gap %.3e, "
        "tol %.0e)"
        % (CARD, n, int(solver.fpm.Nmesh[0]), len(CAT_GRAD_STEPS) - 1,
           finite, peak_gb, dir_rev, dir_fwd, gap_fwd, TOL_DIR, FD_EPS,
           dir_fd, gap_fd, TOL_DIR_FD))
    log("phase 13(a) timing on %s: per KDK step forward %.3f ms, forward + "
        "backward %.3f ms (2-step runs %.3f / %.3f ms, 1-step %.3f / %.3f "
        "ms, each from the noise: shaping, 2LPT, paint); the 2LPT's forward "
        "+ backward %.3f ms"
        % (CARD, t['f2'] - t['f1'], t['b2'] - t['b1'], t['f2'], t['b2'],
           t['f1'], t['b1'], t_lpt))
    if not finite:
        raise AssertionError("the catalog gradient is not finite")
    if not gap_fwd <= TOL_DIR:
        raise AssertionError("reverse and forward mode disagree on the "
                             "catalog model")
    if not gap_fd <= TOL_DIR_FD:
        raise AssertionError("the catalog gradient disagrees with the f8 "
                             "central difference")
    del solver, noise, v
    torch.cuda.empty_cache()
    return dict(peak_gb=peak_gb)


def binned_grad_run(solver, dslots, valid, bounds, fft, backward=True):
    """the gradient of sum over the valid slots of F^2 (force_binned,
    spectral) with respect to the slot displacements"""
    leaves = [[d.detach().clone().requires_grad_() for d in dk]
              for dk in dslots]
    F = solver.force_binned(leaves, valid, bounds, fft=fft)
    loss = sum((f * f * v).sum() for fk, v in zip(F, valid) for f in fk)
    if not backward:
        return loss
    return torch.autograd.grad(loss, [d for dk in leaves for d in dk])


def phase_reverse_binned(dev, n=N):
    """13(b): force_binned under autograd at n^3, K = 2, from phase 6's
    state, both FFTs; nbody_binned under autograd refuses on the card"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    pm = ParticleMesh([n] * 3, BoxSize=float(n), dtype='f4',
                      resampler='cic', device=dev)
    solver = Solver(pm)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    shape = (n,) * 3
    disp = tuple(0.05 + 0.9 * torch.rand(shape, generator=gen, device=dev)
                 for _ in range(3))
    vel = tuple(0.02 * torch.randn(shape, generator=gen, device=dev)
                for _ in range(3))
    dslots, _, valid = bn.from_lattice(disp, vel, nslots=BINNED_GRAD_K)
    bounds = (-0.5, 1.5)
    grads = {}
    for fft in ('xla', 'mxu'):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        g = binned_grad_run(solver, dslots, valid, bounds, fft)
        torch.cuda.synchronize()
        launches = counters()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        need = {k: f + b for k, (f, b) in GRAD_BINNED.items()}
        if fft == 'mxu':
            need.update((k, f + b) for k, (f, b) in GRAD_MXU.items())
        got = {k: launches.get(k, 0) for k in need}
        others = {k: c for k, c in launches.items() if k not in need and c}
        finite = all(bool(torch.isfinite(x).all()) for x in g)
        f_ms = cuda_ms(lambda: binned_grad_run(solver, dslots, valid, bounds,
                                               fft, False), 3)
        b_ms = cuda_ms(lambda: binned_grad_run(solver, dslots, valid, bounds,
                                               fft), 3)
        log("phase 13(b) binned reverse mode, fft=%r on %s: %d^3 K=%d, "
            "d/d(dslots) of sum over the valid slots of F^2: finite %s, "
            "max|g| %.4e, launches %s (need %s, others %s), peak %.2f GB; "
            "per force forward %.3f ms, forward + backward %.3f ms"
            % (fft, CARD, n, BINNED_GRAD_K, finite,
               max(float(x.abs().max()) for x in g), json.dumps(got),
               json.dumps(need), json.dumps(others), peak_gb, f_ms, b_ms))
        if not finite:
            raise AssertionError("the binned force gradient is not finite "
                                 "(fft=%r)" % fft)
        if got != need or others:
            raise AssertionError("the binned force's backward did not run "
                                 "on the kernels (fft=%r)" % fft)
        grads[fft] = g
    ok, line = grad_gap(grads['mxu'], grads['xla'], TOL_GRAD, GRAD_OUTLIERS)
    log("phase 13(b) binned gradient: fft='mxu' against fft='xla', CIC: "
        + line)
    if not ok:
        raise AssertionError("the mxu and xla binned gradients disagree")
    del grads, g, dslots, valid, disp, vel, solver
    torch.cuda.empty_cache()
    # the whole loop under autograd: the CUDA rebase has no rule
    small = ParticleMesh([32] * 3, BoxSize=32.0, dtype='f4',
                         resampler='cic', device=dev)
    d0 = tuple((0.05 + 0.9 * torch.rand((32,) * 3, generator=gen,
                                        device=dev)).requires_grad_()
               for _ in range(3))
    v0 = tuple(torch.zeros((32,) * 3, device=dev) for _ in range(3))
    try:
        Solver(small).nbody_binned(d0, v0, [0.5, 0.55, 0.6], **BINNED_KW)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError("nbody_binned under autograd ran on the card")
    log("phase 13(b) nbody_binned under autograd on %s refuses: %s"
        % (CARD, refusal))
    if "no gradient rule" not in refusal:
        raise AssertionError("nbody_binned refused for another reason")


def rel_max(got, ref):
    """max|got - ref| / max|ref| of two tensors (real or complex) on any
    devices"""
    got, ref = got.detach().cpu(), ref.detach().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def phase_legacy(dev, n=LEGACY_N, npart=LEGACY_NPART, nl=LANCZOS_N):
    """13(d): the legacy pipeline of tests/test_legacy.py at n^3 with
    npart^3 particles against the modern API, on the card; a legacy
    lanczos paint at nl^3, card against CPU"""
    import warnings
    from pmesh_tpu_torch import ParticleMesh, RealField
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from pmesh_tpu_torch.legacy import lanczos
        from pmesh_tpu_torch.legacy.particlemesh import (
            ParticleMesh as LegacyPM)
        from pmesh_tpu_torch.legacy.transfer import TransferFunction as TF
    box = float(n)
    smoothing, const = 1.25, 4 * np.pi * 43007.1
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    pos = torch.rand((npart ** 3, 3), generator=gen, device=dev) * box
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lpm = LegacyPM(BoxSize=box, Nmesh=n, dtype='f4', device=dev)
    lpm.clear()
    lpm.paint(pos)
    painted = lpm.real
    lpm.r2c()
    lpm.push()
    lpm.transfer([TF.RemoveDC, TF.Trilinear, TF.Gaussian(smoothing),
                  TF.Poisson, TF.Constant(const)])
    chained = lpm.complex
    lpm.c2r([TF.SuperLanzcos(0)])
    acc = lpm.readout(pos)
    lpm.pop()
    torch.cuda.synchronize()
    t_legacy = time.perf_counter() - t0

    # the modern API on the circular frequencies w
    pm = ParticleMesh([n] * 3, BoxSize=box, dtype='f4', resampler='cic',
                      device=dev)

    def chain(w, v):
        w2 = sum(wi ** 2 for wi in w)
        trilinear = 1.0
        for wi in w:
            trilinear = trilinear * torch.sinc(wi / (2 * np.pi)) ** 2
        v = v * (w2 > 0) / trilinear * torch.exp(-0.5 * w2 * smoothing ** 2)
        v = torch.where(w2 == 0, 0.0, v / -torch.where(w2 == 0, 1.0, w2))
        return v * const
    rho = pm.paint(pos)
    rhok = rho.r2c()
    ck = rhok.apply(chain, kind='circular')
    # SuperLanzcos(0): direction 0, the default order, 1/6 (8 sin w - sin 2w)
    force = ck.apply(lambda w, v: v * ((8 * torch.sin(w[0])
                                        - torch.sin(2 * w[0])) / 6.0 * 1j),
                     kind='circular').c2r()
    ref_acc = force.readout(pos)
    gaps = {
        'paint': rel_max(painted, rho.value),
        'transfers': rel_max(chained, ck.value),
        'c2r': rel_max(lpm.real, force.value),
        'readout': rel_max(acc, ref_acc),
        'pop': rel_max(lpm.complex, rhok.value)}
    # the lanczos window, card against CPU
    pos_l = torch.rand((nl ** 3 // 8, 3), generator=gen, device=dev) * nl
    win = lanczos.lanczos3
    out = {}
    for device in (dev, 'cpu'):
        out[str(device)] = lanczos.paint(
            pos_l.to(device), torch.zeros((nl,) * 3, device=device),
            window=win, period=nl).cpu()
    gaps['lanczos3 %d^3' % nl] = rel_max(out[str(dev)], out['cpu'])
    log("phase 13(d) legacy package on %s: ParticleMesh pipeline at %d^3 "
        "with %d^3 particles (paint, r2c, push, 5 transfers, c2r with "
        "SuperLanzcos, readout, pop) in %.3f s, against the modern API, "
        "max|d|/max: %s (tol %.0e); lanczos3 paint, card against CPU"
        % (CARD, n, npart, t_legacy,
           ", ".join("%s %.3e" % kv for kv in gaps.items()), TOL_LEGACY))
    if not all(v <= TOL_LEGACY for v in gaps.values()):
        raise AssertionError("the legacy package disagrees with the modern "
                             "API or the CPU")


# --- the sharded catalog path (phase 14) ------------------------------------
#
# launch.spawn('chip_smoke:card_catalog', RANKS, ...) starts RANKS ranks
# on the card (gloo, staged through the host, as phase 9), each on block
# b of the particles and slab b of the meshes, at phase 11's
# configuration.  Phase 11's single-device states (the 2LPT state and the
# state after CAT_REF_STEP KDK steps, in ID order) reach the ranks as .npy
# files; rank 0 gathers the sharded states by ID and compares.
CAT_REF_STEP = 3
# phases 14 and 15 (a), (b): the first CAT_REF_STEP of phase 11's KDK
# steps (a = 0.1 to 0.4; cut from all 10 when phase 16 joined, to keep
# the script within its time); the state check after CAT_REF_STEP steps
# and the growth check still hold
SHARDED_CAT_STEPS = CAT_STEPS[:CAT_REF_STEP + 1]
CAT_REBALANCE = 1.0         # reshard whenever the load is uneven at all
TOL_CAT_SHARDED = 1e-4      # sharded vs one device, of max|ref|


def catalog_ids(Q):
    """the C-order ID of each particle of phase 11's lattice Q (shift 0)"""
    n = CAT_N
    i = torch.remainder(torch.round(Q / (CAT_BOX / n)).long(), n)
    return (i[:, 0] * n + i[:, 1]) * n + i[:, 2]


def gather_rows(pm, t):
    """on rank 0, the rows of every rank's ``t`` in rank order, blocks
    of any length (None on the others)"""
    from pmesh_tpu_torch.parallel import comm
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [int(c) for c in comm.all_gather(n, pm).cpu()]
    nl = max(counts)
    if t.shape[0] < nl:
        t = torch.cat([t, t.new_zeros((nl - t.shape[0],)
                                      + tuple(t.shape[1:]))])
    out = comm.gather(t.contiguous(), pm)
    if out is None:
        return None
    return torch.cat([out[r * nl:r * nl + c] for r, c in enumerate(counts)])


def gather_field(f):
    """on rank 0, the whole field ``f`` from every rank's block (None on
    the others)"""
    from pmesh_tpu_torch.parallel import comm
    pm = f.pm.procmesh
    at = torch.tensor([v for lohi in f.pm.local_block(type(f)) for v in lohi],
                      dtype=torch.int64, device=f.value.device)
    ats = comm.all_gather(at[None], pm).cpu().tolist()
    flat = gather_rows(pm, f.value.reshape(-1))
    if flat is None:
        return None
    ndim = f.value.dim()
    shape = [max(a[2 * d + 1] for a in ats) for d in range(ndim)]
    out = flat.new_empty(shape)
    off = 0
    for a in ats:
        sl = tuple(slice(a[2 * d], a[2 * d + 1]) for d in range(ndim))
        n = int(np.prod([a[2 * d + 1] - a[2 * d] for d in range(ndim)]))
        out[sl] = flat[off:off + n].reshape(out[sl].shape)
        off += n
    return out


def gather_by_id(pm, ids, *arrays):
    """on rank 0, ``arrays`` of every rank in ID order (None elsewhere)"""
    ids = gather_rows(pm, ids)
    out = [gather_rows(pm, a) for a in arrays]
    if pm.rank != 0:
        return None
    order = torch.argsort(ids)
    if not torch.equal(ids[order], torch.arange(len(ids), device=ids.device)):
        raise AssertionError("the gathered IDs are not each particle once")
    return [a[order] for a in out]


def rel_ref(got, ref):
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def plan_record(lay):
    """the ghosts each channel of a plan ships, and its channels and
    capacities"""
    if hasattr(lay, 'offsets'):
        return dict(ghosts=[int((i >= 0).sum()) for i in lay.send_idx],
                    channels=[list(o) for o in lay.offsets],
                    caps=list(lay.caps))
    return dict(ghosts=(lay.send_idx >= 0).sum(dim=1).tolist(),
                channels=[[m * s] for m in range(1, lay.kside + 1)
                          for s in (-1, 1)],
                caps=[lay.capacity] * (2 * lay.kside))


def listed(d):
    """a dict of numbers and arrays as JSON-ready lists"""
    return {k: np.asarray(v).tolist() if not np.isscalar(v) else v
            for k, v in d.items()}


def card_catalog(pm, refdir, steps=CAT_STEPS):
    """what each rank of phases 14 and 15 (a), (b) runs on the rank's
    ProcessMesh ``pm`` (see phase_sharded_catalog)"""
    import torch.distributed as dist
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    from pmesh_tpu_torch.ops import power as pw
    from pmesh_tpu_torch.parallel import comm
    dev = pm.device
    torch.cuda.reset_peak_memory_stats(dev)
    pm8 = ParticleMesh([CAT_N] * 3, BoxSize=CAT_BOX, dtype='f4',
                       resampler='cic', procmesh=pm)
    solver = Solver(pm8, Planck15, B=CAT_B)
    fpm = solver.fpm
    npart = CAT_N ** 3
    rec = dict(route=fpm.route, grid=list(pm.grid),
               slab=fpm.local_block('real')[0],
               particle_slab=pm8.local_block('real')[0])

    def one_device():
        return ParticleMesh([CAT_N] * 3, BoxSize=CAT_BOX, dtype='f4',
                            resampler='cic', device=dev)

    def sync():
        torch.cuda.synchronize(dev)
        dist.barrier()

    # the noise: each rank's own block, rank 0 against the whole fill
    sync()
    t0 = time.perf_counter()
    for compat in ('gadget', 'native'):
        noise = pm8.generate_whitenoise(SEED, type='complex', compat=compat)
        sync()
        got = gather_field(noise)
        if pm.rank == 0:
            whole = one_device().generate_whitenoise(SEED, type='complex',
                                                     compat=compat).value
            rec['noise_' + compat] = bool(torch.equal(got, whole))
        del noise, got
    rec['noise_s'] = time.perf_counter() - t0

    # the initial conditions
    sync()
    t0 = time.perf_counter()
    dlinear = solver.linear_field(EHPower(Planck15), SEED, compat='gadget')
    state0 = solver.lpt(dlinear, steps[0], order=2)
    sync()
    rec['ic_s'] = time.perf_counter() - t0
    del dlinear
    ids = catalog_ids(state0.Q)
    ref = {k: np.load(os.path.join(refdir, k + '.npy'), mmap_mode='r')
           for k in ('S0', 'V0', 'S3', 'V3')} if pm.rank == 0 else None
    got = gather_by_id(pm, ids, state0.S, state0.V)
    if pm.rank == 0:
        rec['lpt'] = max(rel_ref(g, torch.from_numpy(np.array(ref[k]))
                                 .to(dev)) for g, k in zip(got, ('S0', 'V0')))
    del got

    # the exchange plan and one force on the same inputs as one device's
    rec['tune'] = listed(solver.tune_exchange(state0.X))
    rec['load0'] = listed(solver.last_load)
    lay = fpm.decompose(state0.X, **solver._exch_kwargs)
    rec.update(plan_record(lay))
    rec['badness'] = float(lay.badness)
    del lay
    sync()
    comm.reset_staged()
    t0 = time.perf_counter()
    F = solver.force(state0.X)
    sync()
    rec['force_s'] = time.perf_counter() - t0
    rec['force_staged_bytes'] = sum(comm.STAGED_BYTES.values())
    got = gather_by_id(pm, ids, state0.X, F)
    del F
    if pm.rank == 0:
        X1, F1 = got
        one = Solver(one_device(), Planck15, B=CAT_B)
        rec['force'] = rel_ref(F1, one.force(X1))
        del one, X1, F1
    del got
    torch.cuda.empty_cache()

    # the run: nbody with rebalance; rank 0 holds the state after
    # CAT_REF_STEP steps against phase 11's
    calls = []
    orig = fpm.reshard_particles

    def counting(*a):
        calls.append(1)
        return orig(*a)
    fpm.reshard_particles = counting
    times, held = [], [0.0]

    def monitor(a, state):
        sync()
        times.append(time.perf_counter())
        if len(times) == CAT_REF_STEP:
            g = gather_by_id(pm, catalog_ids(state.Q), state.S, state.V)
            if pm.rank == 0:
                rec['step3'] = max(
                    rel_ref(x, torch.from_numpy(np.array(ref[k])).to(dev))
                    for x, k in zip(g, ('S3', 'V3')))
            del g
            sync()
            held[0] = time.perf_counter() - times[-1]
        rec.setdefault('loads', []).append(
            round(solver.last_load['imbalance'], 6))
    sync()
    t0 = time.perf_counter()
    final = solver.nbody(state0, steps, monitor=monitor,
                         rebalance=CAT_REBALANCE)
    sync()
    nsteps = len(steps) - 1
    rec['nsteps'] = nsteps
    rec['run_s'] = time.perf_counter() - t0 - held[0]
    # steps 2..n: the first holds nbody's initial force
    rec['step_ms'] = ((times[-1] - times[0] - held[0]) / (nsteps - 1)) * 1e3
    rec['rebalances'] = len(calls)
    rec['last_load'] = listed(solver.last_load)
    rec['tune_final'] = listed(solver._exch_kwargs)
    tensors = (final.Q, final.S, final.V, state0.S, state0.V)
    rec['finite'] = bool(all(torch.isfinite(t).all() for t in tensors))
    rec['on_cuda'] = all(t.device.type == 'cuda' for t in tensors)
    rec['nlocal'] = final.X.shape[0]
    mass = float(fpm.paint(final.X).csum(dtype=torch.float64))
    rec['mass_err'] = abs(mass - npart) / npart
    k, p0, nmodes = pw.fftpower(pm8.paint(state0.X))
    _, p1, _ = pw.fftpower(pm8.paint(final.X))
    low = [i for i in range(len(nmodes)) if float(k[i]) > 0][:3]
    growth = (Planck15.D1(steps[-1]) / Planck15.D1(steps[0])) ** 2
    rec['growth'] = [float(p1[i] / p0[i]) / growth for i in low]
    rec['k'] = [float(k[i]) for i in low]
    rec['peak_gb'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return rec


def run_sharded_catalog(dev, ref, world, shape=None,
                        steps=SHARDED_CAT_STEPS):
    """card_catalog on ``world`` ranks of the card (a 2-d grid of
    ``shape``, or the slab grid): (the ranks' records, the job's
    seconds)"""
    import tempfile
    from pmesh_tpu_torch.parallel import launch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ref_") as refdir:
        for k, v in ref.items():
            np.save(os.path.join(refdir, k + '.npy'), v.numpy())
        t0 = time.perf_counter()
        out = launch.spawn('chip_smoke:card_catalog', world, 'gloo',
                           dev.type, refdir, steps, shape=shape)
        wall = time.perf_counter() - t0
    return out, wall


def report_sharded_catalog(phase, out, wall):
    """phase 14's and 15's lines and checks of a card_catalog job"""
    r0 = out[0]
    label = ("%d ranks (%s grid %s) on one card over gloo, staged through "
             "the host (no multi-GPU figure)"
             % (len(out), r0['route'], "x".join(map(str, r0['grid']))))
    log("phase %s sharded catalog on %s: %s; %d^3 particles, %d^3 CIC force "
        "mesh (B=%d), f4; noise both fills %.3f s, IC (linear field + 2LPT) "
        "%.3f s, one force %.3f s, %d KDK steps %.3f s"
        % (phase, CARD, label, CAT_N, CAT_N * CAT_B, CAT_B, r0['noise_s'],
           r0['ic_s'], r0['force_s'], r0['nsteps'], r0['run_s']))
    log("phase %s blocks: force mesh x rows %s, particle mesh x rows %s "
        "(per rank)" % (phase, [r['slab'] for r in out],
                         [r['particle_slab'] for r in out]))
    log("phase %s load (every rank's, as each rank measures it): after "
        "tuning on the 2LPT state %s; after the run %s; imbalance per step "
        "%s" % (phase, json.dumps(r0['load0']), json.dumps(r0['last_load']),
                r0['loads']))
    for b, r in enumerate(out):
        log("phase %s rank %d: plan on the 2LPT state %s, channels %s, "
            "capacities %s, ghosts sent per channel %s, badness %g; after "
            "the run %d particles, plan %s; peak %.2f GB%s"
            % (phase, b, json.dumps(r['tune']), r['channels'], r['caps'],
               r['ghosts'], r['badness'], r['nlocal'],
               json.dumps(r['tune_final']), r['peak_gb'],
               " (with the one-device force)" if b == 0 else ""))
    log("phase %s timing on %s (%s): %.3f ms per KDK step (steps 2..%d, "
        "each with its load measurement and, past rebalance=%g, a reshard "
        "and re-tune), %d rebalances; %.3f MB staged through the host per "
        "force (rank 0: the FFTs' all_to_alls and the ghost channels)"
        % (phase, CARD, label, r0['step_ms'], r0['nsteps'], CAT_REBALANCE,
           r0['rebalances'], r0['force_staged_bytes'] / 1e6))
    ok = dict(
        noise=r0['noise_gadget'] and r0['noise_native'],
        lpt=r0['lpt'] <= TOL_CAT_SHARDED,
        force=r0['force'] <= TOL_CAT_SHARDED,
        step3=r0['step3'] <= TOL_CAT_SHARDED,
        finite=all(r['finite'] for r in out),
        on_cuda=all(r['on_cuda'] for r in out),
        mass=r0['mass_err'] <= TOL_MASS,
        growth=all(abs(g - 1.0) <= TOL_GROWTH for g in r0['growth']),
        plan=all(r['badness'] == 0.0 for r in out),
        rebalanced=r0['rebalances'] >= 1)
    log("phase %s checks on %s: noise bitwise (gadget %s, native %s); 2LPT "
        "state by ID max|d|/max = %.3e, force on the same particles %.3e of "
        "max|F|, state after %d KDK steps %.3e (tol %.0e); finite %s, on the "
        "card %s, mass error %.3e (tol %.0e), P_final/P_initial / (D1 "
        "ratio)^2 = %s at k = %s (tol %.2f); the job took %.3f s: %s"
        % (phase, CARD, r0['noise_gadget'], r0['noise_native'], r0['lpt'],
           r0['force'], CAT_REF_STEP, r0['step3'], TOL_CAT_SHARDED,
           ok['finite'], ok['on_cuda'], r0['mass_err'], TOL_MASS,
           " ".join("%.4f" % g for g in r0['growth']),
           " ".join("%.5f" % k for k in r0['k']), TOL_GROWTH, wall,
           "ok" if all(ok.values()) else "FAIL"))
    if not all(ok.values()):
        raise AssertionError("phase %s: the sharded catalog run failed its "
                             "checks: %s" % (phase, ", ".join(
                                 k for k, v in ok.items() if not v)))


def phase_sharded_catalog(dev, ref):
    """RANKS ranks on the card at phase 11's catalog configuration (256^3
    particles, a 512^3 CIC force mesh, f4, gadget noise of SEED, 2LPT at
    a = 0.1, the SHARDED_CAT_STEPS: 3 KDK steps to a = 0.4, cut from
    phase 11's 10): the sharded noise bitwise the
    single-device fill, the sharded 2LPT state and the state after
    CAT_REF_STEP KDK steps by ID against phase 11's within 1e-4, one
    force on the sharded 2LPT state against the single-device force on
    the same particles within 1e-4 of max|F|; Solver.nbody with
    tune_exchange and rebalance, then finite, on the card, mass conserved
    and the lowest k bins grown as D1^2.  The ranks share one card over
    gloo, staged through the host: the times are no multi-GPU figure."""
    out, wall = run_sharded_catalog(dev, ref, RANKS)
    report_sharded_catalog('14', out, wall)


PENCIL_GRID = (2, 2)
UNEVEN_RANKS = 5            # 512 = 4 x 103 + 100, 256 = 4 x 52 + 48
REPLICATED_RANKS = 3        # 512 over 3: the slabs cannot reach the seam
GEOMETRY_SMALL = 32
TOL_GEOMETRY = 1e-10        # f8 card vs CPU, of max


def card_replicated(pm, refdir):
    """what each rank of phase 15(c) runs: phase 11's 2LPT state, this
    rank's block of it, one force on the replicated route"""
    import warnings
    import torch.distributed as dist
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    dev = pm.device
    torch.cuda.reset_peak_memory_stats(dev)
    pm8 = ParticleMesh([CAT_N] * 3, BoxSize=CAT_BOX, dtype='f4',
                       resampler='cic', procmesh=pm)
    solver = Solver(pm8, Planck15, B=CAT_B)
    Q = pm8.generate_uniform_particle_grid(shift=0.0)
    S0 = np.load(os.path.join(refdir, 'S0.npy'), mmap_mode='r')
    nl = -(-len(S0) // pm.size)
    lo = min(pm.rank * nl, len(S0))
    X = Q + torch.from_numpy(np.array(S0[lo:lo + nl])).to(dev)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        F = solver.force(X)
        torch.cuda.synchronize(dev)
        dist.barrier()
        force_s = time.perf_counter() - t0
    rec = dict(route=(pm8.route, solver.fpm.route), force_s=force_s,
               warned=[str(x.message) for x in w
                       if issubclass(x.category, RuntimeWarning)],
               peak_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    X1 = gather_rows(pm, X)
    F1 = gather_rows(pm, F)
    del F
    if pm.rank == 0:
        one = Solver(ParticleMesh([CAT_N] * 3, BoxSize=CAT_BOX, dtype='f4',
                                  resampler='cic', device=dev),
                     Planck15, B=CAT_B)
        rec['force'] = rel_ref(F1, one.force(X1))
    return rec


def geometry_small(pm):
    """what each rank of phase 15(c)'s small check runs: a 32^3 c2c round
    trip and a 32^2 r2c and c2r on this rank's slab, in f8, against the
    same transforms of the whole mesh on the CPU"""
    from pmesh_tpu_torch import ParticleMesh
    out = {}
    for name, shape, dtype in (('c2c', (GEOMETRY_SMALL,) * 3, 'c16'),
                               ('2d', (GEOMETRY_SMALL,) * 2, 'f8')):
        r = np.random.RandomState(SEED)
        x = r.normal(size=shape)
        if dtype == 'c16':
            x = x + 1j * r.normal(size=shape)
        card = ParticleMesh(shape, 1.0, dtype=dtype, procmesh=pm)
        cpu = ParticleMesh(shape, 1.0, dtype=dtype, device='cpu')
        sl = tuple(slice(a, b) for a, b in card.local_block('real'))
        real = card.create(type='real', value=torch.from_numpy(
            np.ascontiguousarray(x[sl])).to(pm.device))
        spec = real.r2c()
        back = spec.c2r()
        ref = cpu.create(type='real', value=torch.from_numpy(x)).r2c()
        csl = tuple(slice(a, b) for a, b in card.local_block('complex'))
        def gap(got, want):
            # a rank's block may be empty (the 2-d half spectrum's 17
            # columns over 4 ranks)
            d = (got.cpu() - want).abs()
            return float(d.max()) if d.numel() else 0.0
        out[name] = dict(
            route=card.route,
            spectrum=gap(spec.value, ref.value[csl])
            / float(np.abs(ref.value.numpy()).max()),
            back=gap(back.value, torch.from_numpy(x[sl]))
            / float(np.abs(x).max()),
            on_cuda=spec.value.device.type == 'cuda')
    return out


def phase_geometries(dev, ref):
    """phase 15 (see the module docstring): phase 14's run on a (2, 2)
    pencil grid and on 5 uneven slab ranks; one force on 3 ranks of the
    replicated route; small c2c and 2-d meshes on 4 slab ranks, card
    against CPU"""
    import tempfile
    from pmesh_tpu_torch.parallel import launch
    for part, world, shape in (('15a', PENCIL_GRID[0] * PENCIL_GRID[1],
                                PENCIL_GRID), ('15b', UNEVEN_RANKS, None)):
        out, wall = run_sharded_catalog(dev, ref, world, shape)
        want = 'pencil' if shape else 'slab'
        if not all(r['route'] == want for r in out):
            raise AssertionError("phase %s ran on the %s route, not %s"
                                 % (part, out[0]['route'], want))
        report_sharded_catalog(part, out, wall)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ref_") as refdir:
        np.save(os.path.join(refdir, 'S0.npy'), ref['S0'].numpy())
        t0 = time.perf_counter()
        out = launch.spawn('chip_smoke:card_replicated', REPLICATED_RANKS,
                           'gloo', dev.type, refdir)
        wall = time.perf_counter() - t0
    r0 = out[0]
    warned = all(any("no sharded particle plan" in m for m in r['warned'])
                 for r in out)
    log("phase 15c replicated route on %s: %d ranks, %d^3 particles on a "
        "%d^3 CIC force mesh (routes %s): decompose warned on every rank "
        "%s; one force %.3f s (every rank paints its particles into the "
        "whole mesh, an all_reduce sums them, each rank transforms and "
        "reads alone), %.3e of max|F| from the one-device force on phase "
        "11's 2LPT state (tol %.0e); peak per rank %s GB; the job took "
        "%.3f s" % (CARD, REPLICATED_RANKS, CAT_N, CAT_N * CAT_B,
                    "/".join(r0['route']), warned, r0['force_s'], r0['force'],
                    TOL_CAT_SHARDED, " ".join("%.2f" % r['peak_gb']
                                              for r in out), wall))
    small = launch.spawn('chip_smoke:geometry_small', RANKS, 'gloo',
                         dev.type)
    worst = {k: max(max(r[k]['spectrum'], r[k]['back']) for r in small)
             for k in small[0]}
    log("phase 15c small meshes on %s, %d slab ranks, f8, card vs CPU "
        "(max |d| / max): %d^3 c2c %.3e, %d^2 r2c/c2r %.3e (tol %.0e)"
        % (CARD, RANKS, GEOMETRY_SMALL, worst['c2c'], GEOMETRY_SMALL,
           worst['2d'], TOL_GEOMETRY))
    ok = dict(routes=all(r['route'] == ('replicated', 'replicated')
                         for r in out),
              warned=warned, force=r0['force'] <= TOL_CAT_SHARDED,
              small=all(v <= TOL_GEOMETRY for v in worst.values()),
              small_routes=all(r[k]['route'] == 'slab' and r[k]['on_cuda']
                               for r in small for k in r))
    if not all(ok.values()):
        raise AssertionError("phase 15c failed its checks: %s" % ", ".join(
            k for k, v in ok.items() if not v))


# --- phase 16: reverse mode on the sharded routes ---------------------------

REV_SMALL = 32              # (c) the catalog model at 32^3, f8
REV_BINNED = 128            # (c) force_binned at 128^3, K = BINNED_GRAD_K
REV_UNEVEN_RANKS = 5        # 32 over 5: 7-row slabs reaching the seam
REV_REPLICATED_RANKS = 3    # 32 over 3: the replicated route
TOL_REV_CAT = 1e-3          # (b) sharded against one device, of max|g|
TOL_REV_DIR = 1e-4          # (b) <grad L, v> and the jvp, relative
TOL_REV_SMALL = 1e-8        # (c) f8 card against the CPU, of max|g|


def rev_need(forces):
    """(a)'s backward launches summed over the ranks: per force the
    x-halo paint and readout backwards of GRAD_LATTICE and the ct2
    transposes of GRAD_MXU (only=d), on every rank"""
    need = {k + "_xhalo": RANKS * forces * b
            for k, (f, b) in GRAD_LATTICE.items()}
    need.update((k, RANKS * forces * b) for k, (f, b) in GRAD_MXU.items()
                if b)
    return need


def dist_gap(got, ref, tol, outliers, held=True):
    """grad_gap over the ranks' blocks (each rank its own block of
    ``got`` and ``ref``): every rank returns the same (ok, line); a gap
    not ``held`` is described without a verdict"""
    import torch.distributed as dist
    num = sum(float(((g - r).double() ** 2).sum()) for g, r in zip(got, ref))
    den = sum(float((r.double() ** 2).sum()) for r in ref)
    size = sum(r.numel() for r in ref)
    sums = torch.tensor([num, den, float(size)], dtype=torch.float64)
    dist.all_reduce(sums)
    tops = torch.tensor([max(float(r.abs().max()) for r in ref),
                         max(float((g - r).abs().max())
                             for g, r in zip(got, ref))],
                        dtype=torch.float64)
    dist.all_reduce(tops, op=dist.ReduceOp.MAX)
    num, den, size = float(sums[0]), float(sums[1]), int(sums[2])
    scale, err = float(tops[0]), float(tops[1])
    out = torch.tensor([sum(int(((g - r).abs() > tol * scale).sum())
                            for g, r in zip(got, ref))], dtype=torch.int64)
    dist.all_reduce(out)
    out = int(out[0])
    ok = bool(np.isfinite(num)) and out <= outliers * size
    verdict = (" (at most %d allowed) %s" % (int(outliers * size),
                                             "ok" if ok else "FAIL")
               if held else "")
    return ok, ("%d of %d entries off by more than %.0e of max|g|%s; "
                "max|dg|/max|g| = %.3e, |dg|_2/|g|_2 = %.3e"
                % (out, size, tol, verdict, err / scale, (num / den) ** 0.5))


def rank_sum(x):
    """a float summed over the ranks"""
    import torch.distributed as dist
    t = torch.tensor([float(x)], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t[0])


def synced(pm):
    """every rank's card idle and every rank here: a point to start or
    stop a clock"""
    import torch.distributed as dist
    torch.cuda.synchronize(pm.device)
    dist.barrier()
    return time.perf_counter()


def card_reverse_lattice(pm, refdir):
    """16(a) on each rank: phase 4d's loss (sum(S^2 + 2 V^2) after 2
    KDK steps of nbody_lattice, fft='mxu') at N^3 from the sharded 2LPT
    state of phase 4's linear field; its gradient on this rank's slabs
    against phase 4d's one-device gradient (``refdir``), the launches
    and the staged bytes of the backward alone, the forward and forward
    + backward of 1- and 2-step runs; then one force's gradient with
    fft='xla' beside fft='mxu'"""
    from pmesh_tpu_torch import ComplexField, ParticleMesh
    from pmesh_tpu_torch import convert
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.parallel.comm import STAGED_BYTES
    dev = pm.device
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pm1 = ParticleMesh([N] * 3, BOX, dtype='f4', device=dev)
    dl1 = linear_field(pm1, gen)
    solver = Solver(ParticleMesh([N] * 3, BOX, dtype='f4', procmesh=pm))
    dk = solver.pm.create(type=ComplexField, value=convert.to_slabs(
        dl1.value, pm, axis=1))
    del dl1, pm1
    state = sum(solver.lpt_lattice(dk, A0, order=2), ())
    del dk
    torch.cuda.empty_cache()
    rows = N // pm.size
    rec = {}
    leaves = [t.detach().clone().requires_grad_() for t in state]
    t0 = synced(pm)
    reset_counters()
    S, V = solver.nbody_lattice(leaves[:3], leaves[3:], GRAD_STEPS, BOUNDS,
                                fft='mxu')
    loss = sum((s * s).sum() + 2 * (v * v).sum() for s, v in zip(S, V))
    del S, V
    t1 = synced(pm)
    reset_counters()
    g = torch.autograd.grad(loss, leaves)
    t2 = synced(pm)
    rec['launches'] = {k: v for k, v in counters().items() if v}
    rec['staged'] = dict(STAGED_BYTES)
    rec['peak_gb'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rec['f2'], rec['b2'] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    del loss, leaves
    ref = [torch.from_numpy(np.array(np.load(
        os.path.join(refdir, 'grad4d_%d.npy' % k), mmap_mode='r')[
            pm.rank * rows:(pm.rank + 1) * rows])).to(dev) for k in range(6)]
    rec['finite'] = all(bool(torch.isfinite(x).all()) for x in g)
    rec['gap'] = dist_gap(g, ref, TOL_GRAD, GRAD_OUTLIERS)
    del g, ref
    torch.cuda.empty_cache()
    # the 1-step run, forward and backward
    leaves = [t.detach().clone().requires_grad_() for t in state]
    t0 = synced(pm)
    S, V = solver.nbody_lattice(leaves[:3], leaves[3:], GRAD_STEPS[:2],
                                BOUNDS, fft='mxu')
    loss = sum((s * s).sum() + 2 * (v * v).sum() for s, v in zip(S, V))
    del S, V
    t1 = synced(pm)
    torch.autograd.grad(loss, leaves)
    t2 = synced(pm)
    rec['f1'], rec['b1'] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    del loss, leaves
    torch.cuda.empty_cache()
    # one force's gradient, fft='xla' beside fft='mxu'
    fg = {}
    for fft in ('mxu', 'xla'):
        d = [t.detach().clone().requires_grad_() for t in state[:3]]
        t0 = synced(pm)
        F = solver.force_lattice(d, BOUNDS, fft=fft)
        fg[fft] = torch.autograd.grad(sum((f * f).sum() for f in F), d)
        rec['force_ms_' + fft] = (synced(pm) - t0) * 1e3
        del F, d
    rec['force_gap'] = dist_gap(fg['xla'], fg['mxu'], TOL_GRAD,
                                GRAD_OUTLIERS)
    return rec


def card_reverse_catalog(pm, refdir):
    """16(b) on each rank: phase 13(a)'s model (the gadget noise of SEED,
    2LPT and 2 KDK steps of Solver.nbody, the paint on the 512^3 B = 2
    mesh) on the job's 4 slab ranks, then on the (2, 2) pencil grid of
    the same ranks.  In f8 on both: the gradient of sum (rho - 1)^2 in
    this rank's block of the noise against phase 13(a)'s one-device f8
    gradient and <grad L, v> against its value (and on the slabs one
    torch.func.jvp along v against phase 13(a)'s f8 jvp).  In f4, the
    model's own dtype, on the slabs: the gradient's gap to phase 13(a)'s
    f4 gradient, the backward's staged bytes and the peak, and the
    forward and forward + backward times of 1- and 2-step runs.  Then
    16(c)'s force_binned backward at REV_BINNED^3 on the slabs."""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    from pmesh_tpu_torch.parallel.comm import STAGED_BYTES
    from pmesh_tpu_torch.parallel.pmesh import ProcessMesh
    dev = pm.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    v_all = torch.randn((CAT_N,) * 3, generator=gen, device=dev,
                        dtype=torch.float32)
    power = EHPower(Planck15)
    out = {}

    def setup(mesh, dtype):
        pm8 = ParticleMesh([CAT_N] * 3, BoxSize=CAT_BOX, dtype=dtype,
                           resampler='cic', procmesh=mesh)
        sl = tuple(slice(a, b) for a, b in pm8.local_block('real'))
        noise = pm8.generate_whitenoise(SEED, type='real',
                                        compat='gadget').value
        return (Solver(pm8, Planck15, B=CAT_B), sl, noise,
                v_all[sl].to(noise.dtype))

    def gradient(mesh, solver, sl, noise, v, ref, held=True):
        """the gradient run: its ms, staged bytes and peak, and its gap
        to ``ref`` by dist_gap at TOL_REV_CAT; <grad L, v>"""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        x = noise.detach().clone().requires_grad_()
        t0 = synced(mesh)
        loss = catalog_loss(solver, power, x)
        reset_counters()
        g, = torch.autograd.grad(loss, x)
        rec = dict(ms=(synced(mesh) - t0) * 1e3, staged=dict(STAGED_BYTES),
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                   finite=bool(torch.isfinite(g).all()),
                   route=(solver.pm.route, solver.fpm.route))
        r = torch.from_numpy(np.array(np.load(ref, mmap_mode='r')[sl])).to(
            dev)
        rec['gap'] = dist_gap((g,), (r,), TOL_REV_CAT, 0, held)
        rec['dir'] = rank_sum((g.double() * v.double()).sum())
        return rec

    for name, mesh in (('slab', pm), ('pencil', ProcessMesh(
            shape=PENCIL_GRID, device=dev))):
        solver, sl, noise, v = setup(mesh, 'f8')
        rec = gradient(mesh, solver, sl, noise, v,
                       os.path.join(refdir, 'cat_grad8.npy'))
        if name == 'slab':
            t0 = synced(mesh)
            _, jv = torch.func.jvp(lambda y: catalog_loss(solver, power, y),
                                   (noise,), (v,))
            rec['jvp'] = rank_sum(jv)
            rec['jvp_ms'] = (synced(mesh) - t0) * 1e3
            del solver, noise, v
            # the model's own dtype: the times, the bytes and the peak
            solver, sl, noise, v = setup(mesh, 'f4')
            rec['f4'] = gradient(mesh, solver, sl, noise, v,
                                 os.path.join(refdir, 'cat_grad.npy'),
                                 held=False)
            for nst in (1, 2):
                steps = CAT_GRAD_STEPS[:nst + 1]
                t0 = synced(mesh)
                with torch.no_grad():
                    catalog_loss(solver, power, noise, steps)
                rec['f%d' % nst] = (synced(mesh) - t0) * 1e3
            x = noise.detach().clone().requires_grad_()
            t0 = synced(mesh)
            torch.autograd.grad(catalog_loss(solver, power, x,
                                             CAT_GRAD_STEPS[:2]), x)
            rec['b1'] = (synced(mesh) - t0) * 1e3
            del x
        out[name] = rec
        del solver, noise, v
    out['dirs'] = dict(f8=np.load(os.path.join(refdir, 'cat_dir8.npy'))
                       .tolist(),
                       f4=np.load(os.path.join(refdir, 'cat_dir.npy'))
                       .tolist())
    torch.cuda.empty_cache()
    out['binned'] = card_reverse_binned(pm)
    return out


def card_reverse_binned(pm):
    """16(c) on each rank: force_binned (spectral, fft='xla') at
    REV_BINNED^3, K = BINNED_GRAD_K, under autograd on this rank's slabs:
    the backward's launches (the x-halo lattice kernels only), its staged
    bytes and ms; rank 0 holds the gathered gradient against the
    one-device CPU gradient of the same state"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.parallel.comm import STAGED_BYTES
    dev = pm.device
    n = REV_BINNED
    rng = np.random.RandomState(SEED + 16)
    disp = [(0.05 + 0.9 * rng.uniform(size=(n,) * 3)).astype('f4')
            for _ in range(3)]
    rows = n // pm.size
    lo = pm.rank * rows
    rec = {}

    def grads(solver, device, cut):
        d = tuple(torch.from_numpy(np.ascontiguousarray(cut(x))).to(device)
                  for x in disp)
        dslots, valid = bn.from_lattice(d, nslots=BINNED_GRAD_K)
        return binned_grad_run(solver, dslots, valid, (-0.5, 1.5), 'xla')
    solver = Solver(ParticleMesh([n] * 3, BoxSize=float(n), dtype='f4',
                                 resampler='cic', procmesh=pm))
    t0 = synced(pm)
    reset_counters()
    g = grads(solver, dev, lambda x: x[lo:lo + rows])
    rec['ms'] = (synced(pm) - t0) * 1e3
    rec['launches'] = {k: v for k, v in counters().items() if v}
    rec['staged'] = dict(STAGED_BYTES)
    got = [gather_rows(pm, x.reshape(rows, -1)) for x in g]
    if pm.rank == 0:
        one = Solver(ParticleMesh([n] * 3, BoxSize=float(n), dtype='f4',
                                  resampler='cic', device='cpu'))
        ref = grads(one, 'cpu', lambda x: x)
        rec['gap'] = grad_gap([x.cpu().reshape(r.shape) for x, r
                               in zip(got, ref)], ref, TOL_SMALL,
                              GRAD_OUTLIERS)
    return rec


def card_reverse_small(pm):
    """16(c) on each rank: phase 13(a)'s model at REV_SMALL^3 in f8
    (B = CAT_B, the gadget noise of SEED) on this job's ranks (5: the
    uneven slabs, 3: the replicated route); rank 0 holds the gathered
    gradient against the one-device CPU gradient"""
    from pmesh_tpu_torch import ParticleMesh, RealField
    from pmesh_tpu_torch.models.cosmology import Planck15
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.models.powerspectrum import EHPower
    from pmesh_tpu_torch.parallel.comm import STAGED_BYTES
    n, box = REV_SMALL, 2.0 * REV_SMALL
    torch.cuda.reset_peak_memory_stats(pm.device)
    pm8 = ParticleMesh([n] * 3, BoxSize=box, dtype='f8', resampler='cic',
                       procmesh=pm)
    solver = Solver(pm8, Planck15, B=CAT_B)
    power = EHPower(Planck15)
    x = pm8.generate_whitenoise(SEED, type='real',
                                compat='gadget').value.requires_grad_()
    t0 = synced(pm)
    reset_counters()
    g, = torch.autograd.grad(catalog_loss(solver, power, x), x)
    rec = dict(ms=(synced(pm) - t0) * 1e3, staged=dict(STAGED_BYTES),
               route=(pm8.route, solver.fpm.route),
               on_cuda=g.device.type == 'cuda',
               peak_gb=torch.cuda.max_memory_allocated(pm.device) / 2 ** 30)
    whole = gather_field(pm8.create(type=RealField, value=g))
    if pm.rank == 0:
        one, pw, white = catalog_setup('cpu', n, box, 'f8')
        ref = catalog_grad(one, pw, white)
        rec['gap'] = rel_ref(whole.cpu(), ref)
    return rec


def phase_sharded_reverse(dev, refdir):
    """phase 16 (see the module docstring): (a) the lattice gradient on 4
    slab ranks at N^3 against phase 4d's, its backward's launches exact;
    (b) the catalog gradient and jvp on 4 slab ranks and a (2, 2) pencil
    grid against phase 13(a)'s; (c) the f8 32^3 catalog gradient on 5
    uneven ranks and on 3 replicated ranks and the 128^3 force_binned
    backward on 4 slab ranks, card against CPU.  ``refdir`` holds the
    one-device references phases 4d and 13(a) saved."""
    from pmesh_tpu_torch.native import cuda
    from pmesh_tpu_torch.parallel import launch
    for name in ("gridpm", "binned", "fft_mxu"):
        cuda.load(name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fails = []
    t0 = time.perf_counter()
    out = launch.spawn('chip_smoke:card_reverse_lattice', RANKS, 'gloo',
                       dev.type, refdir)
    wall_a = time.perf_counter() - t0
    r0 = out[0]
    forces = len(GRAD_STEPS)
    launches = {}
    for r in out:
        for k, v in r['launches'].items():
            launches[k] = launches.get(k, 0) + v
    need = rev_need(forces)
    ok_gap, line = r0['gap']
    ok_force, fline = r0['force_gap']
    exact = launches == need
    nst = len(GRAD_STEPS) - 1
    log("phase 16(a) sharded lattice reverse mode on %s: %d slab ranks on "
        "one card over gloo (staged through the host), %d^3 f32, "
        "d/d(disp, vel) of sum(S^2 + 2 V^2) after %d KDK steps of "
        "nbody_lattice(fft='mxu') from the sharded 2LPT state: finite %s; "
        "against phase 4d's one-device gradient: %s"
        % (CARD, RANKS, N, nst, all(r['finite'] for r in out), line))
    log("phase 16(a) backward launches summed over the ranks %s (need "
        "exactly %s) %s; staged by the backward per rank %s bytes; peak "
        "per rank %s GB; 2-step run forward %.3f ms + backward %.3f ms, "
        "1-step %.3f + %.3f ms: per KDK step forward %.3f ms, forward + "
        "backward %.3f ms; the job took %.3f s"
        % (json.dumps(launches), json.dumps(need),
           "ok" if exact else "FAIL",
           [r['staged']['to_host'] + r['staged']['to_device'] for r in out],
           " ".join("%.2f" % r['peak_gb'] for r in out), r0['f2'], r0['b2'],
           r0['f1'], r0['b1'], r0['f2'] - r0['f1'],
           r0['f2'] + r0['b2'] - r0['f1'] - r0['b1'], wall_a))
    log("phase 16(a) one force's gradient d/disp sum F^2: fft='xla' "
        "(%.3f ms forward + backward) against fft='mxu' (%.3f ms): %s"
        % (r0['force_ms_xla'], r0['force_ms_mxu'], fline))
    if not (all(r['finite'] for r in out) and ok_gap and exact and ok_force):
        fails.append('16(a)')
    del out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = launch.spawn('chip_smoke:card_reverse_catalog', RANKS, 'gloo',
                       dev.type, refdir)
    wall_b = time.perf_counter() - t0
    (dir8, jvp8), (dir4, _) = out[0]['dirs']['f8'], out[0]['dirs']['f4']
    for name in ('slab', 'pencil'):
        rec = out[0][name]
        ok_gap, line = rec['gap']
        gdir = abs(rec['dir'] - dir8) / abs(dir8)
        ok = (all(r[name]['finite'] for r in out) and ok_gap
              and gdir <= TOL_REV_DIR)
        more = ""
        if 'jvp' in rec:
            gjvp = abs(rec['jvp'] - jvp8) / abs(jvp8)
            ok = ok and gjvp <= TOL_REV_DIR
            f4 = rec['f4']
            more = ("; jvp %.12e against %.12e (gap %.3e, tol %.0e, %.3f "
                    "ms). In f4: against phase 13(a)'s f4 gradient %s, "
                    "<grad L, v> %.9e against %.9e (gap %.3e; f4 rounding, "
                    "which the f8 gaps above bound: not held); per KDK step "
                    "forward %.3f ms, forward + backward %.3f ms (2-step "
                    "runs %.3f / %.3f ms, 1-step %.3f / %.3f ms); staged by "
                    "the f4 backward per rank %s bytes; peak per rank %s GB"
                    % (rec['jvp'], jvp8, gjvp, TOL_REV_DIR, rec['jvp_ms'],
                       f4['gap'][1], f4['dir'], dir4,
                       abs(f4['dir'] - dir4) / abs(dir4),
                       rec['f2'] - rec['f1'], f4['ms'] - rec['b1'],
                       rec['f2'], f4['ms'], rec['f1'], rec['b1'],
                       [r[name]['f4']['staged']['to_host']
                        + r[name]['f4']['staged']['to_device'] for r in out],
                       " ".join("%.2f" % r[name]['f4']['peak_gb']
                                for r in out)))
        log("phase 16(b) sharded catalog reverse mode on %s, %d ranks, %s "
            "route (%s), phase 13(a)'s model (%d^3 particles, %d^3 CIC "
            "mesh, 2LPT + %d KDK steps). In f8: against phase 13(a)'s "
            "one-device f8 gradient %s; <grad L, v> %.12e against %.12e "
            "(gap %.3e, tol %.0e); the gradient run %.3f ms, staged by its "
            "backward per rank %s bytes, peak per rank %s GB%s %s"
            % (CARD, RANKS, name, "/".join(rec['route']), CAT_N,
               CAT_N * CAT_B, len(CAT_GRAD_STEPS) - 1, line, rec['dir'],
               dir8, gdir, TOL_REV_DIR, rec['ms'],
               [r[name]['staged']['to_host'] + r[name]['staged']['to_device']
                for r in out],
               " ".join("%.2f" % r[name]['peak_gb'] for r in out), more,
               "ok" if ok else "FAIL"))
        if not ok:
            fails.append('16(b) ' + name)
    b = out[0]['binned']
    blaunch = {}
    for r in out:
        for k, v in r['binned']['launches'].items():
            blaunch[k] = blaunch.get(k, 0) + v
    bneed = {k + "_xhalo": RANKS * (f + b_)
             for k, (f, b_) in GRAD_BINNED.items()}
    ok_b, bline = b['gap']
    log("phase 16(c) sharded force_binned reverse mode on %s: %d slab ranks, "
        "%d^3 K=%d, fft='xla', d/d(dslots) of sum over the valid slots of "
        "F^2, forward + backward %.3f ms, launches summed over the ranks %s "
        "(need exactly %s), staged per rank %s bytes; card against the "
        "one-device CPU gradient: %s"
        % (CARD, RANKS, REV_BINNED, BINNED_GRAD_K, b['ms'],
           json.dumps(blaunch), json.dumps(bneed),
           [r['binned']['staged']['to_host']
            + r['binned']['staged']['to_device'] for r in out], bline))
    if not (ok_b and blaunch == bneed):
        fails.append('16(c) binned')
    log("phase 16(b) the job took %.3f s" % wall_b)
    del out
    torch.cuda.empty_cache()
    # the two small jobs at once: their time is mostly the ranks' start
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [(world, want, pool.submit(
            launch.spawn, 'chip_smoke:card_reverse_small', world, 'gloo',
            dev.type)) for world, want in ((REV_UNEVEN_RANKS, 'slab'),
                                           (REV_REPLICATED_RANKS,
                                            'replicated'))]
        results = [(world, want, fut.result()) for world, want, fut in jobs]
    wall = time.perf_counter() - t0
    for world, want, out in results:
        r0 = out[0]
        ok = (r0['gap'] <= TOL_REV_SMALL and r0['route'] == (want, want)
              and all(r['on_cuda'] for r in out))
        log("phase 16(c) small catalog reverse mode on %s: %d ranks, %s "
            "route, %d^3 f8, B=%d, 2LPT + %d KDK steps: card against the "
            "one-device CPU gradient max|dg|/max|g| = %.3e (tol %.0e); "
            "forward + backward %.3f ms; staged per rank %s bytes; peak per "
            "rank %s GB; both jobs took %.3f s %s"
            % (CARD, world, "/".join(r0['route']), REV_SMALL, CAT_B,
               len(CAT_GRAD_STEPS) - 1, r0['gap'], TOL_REV_SMALL, r0['ms'],
               [r['staged']['to_host'] + r['staged']['to_device']
                for r in out], " ".join("%.2f" % r['peak_gb'] for r in out),
               wall, "ok" if ok else "FAIL"))
        if not ok:
            fails.append('16(c) %d ranks' % world)
    if fails:
        raise AssertionError("phase 16 failed its checks: %s"
                             % ", ".join(fails))


# --- phase 17: the f64 kernels, the f8 paths, 2-d meshes and the field
# API on the sharded routes -------------------------------------------------

# NVIDIA's published FP64 rate of the H100 SXM outside the tensor cores,
# for the f64 kernels' bounds
PEAK_F64 = 34e12
TOL_F64 = 1e-12         # f64 kernel against its plain version, of max
TOL_F8 = 1e-10          # an f8 path on the card against the plain route
TOL_F8_MASS = 1e-12
TOL_F8_GRAD = 1e-6      # <grad L, v> against the f8 central difference
TOL_F8_GRAD_CIC = 1e-3  # the same with CIC (phase_grad_f8 says why)
# 17(a): the lattice cases at N^3 (nv 3 and 5), the run-time width of
# the f32 kernels (nv 7, a width gridpm64.cu compiles in) at WIDE_N^3 and
# N^3, the x-halo forms on a slab of F64_SLAB_ROWS rows of N^3, the
# rebase at N^3 K = 2 -> 2 and -> 3
F64_BOUNDS = ((-1.0, 1.0), (-2.0, 2.0))
F64_SLAB_ROWS = 128
F64_REBASE = (((-0.5, 1.5), (1.0, 0.25), 2), ((-0.5, 1.5), (1.0, 0.25), 3))
F8_GRAD_N = 256          # phase 4d's loss in f8 (512^3 would take 60 GB)
F8_FD_EPS = 1e-5         # cells, along a unit-rms direction
TWO_D = (256, 4096)      # the 2-d lattice run: card against CPU, card alone
ACCESS_N = CAT_N * CAT_B     # phase 11's force mesh, 512^3 f4
ACCESS_SMALL = 32            # the f8 geometries, card against CPU
ACCESS_STEPS = np.linspace(0.1, 0.2, 4)     # 17(e)'s f8 slab run: 3 KDK
ACCESS_SHARDED_N = 64
ACCESS_INDEX = 8             # seeded indices, each with its dual
TOL_ACCESS_F4 = 1e-5


def plain_route():
    """a context in which the lattice paint and readout and the rebase
    take their plain versions on the card (impl='torch' for every call
    of a Solver, which takes no impl)"""
    import contextlib
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.ops import gridpm as gp

    @contextlib.contextmanager
    def ctx():
        saved = gp.route, bn.route
        gp.route = bn.route = lambda impl, device, ndim: 'torch'
        try:
            yield
        finally:
            gp.route, bn.route = saved
    return ctx()


def timed_once(fn):
    """(fn(), its device ms): one call between CUDA events"""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def rel_max(got, ref):
    """max over the tensors of max|got - ref| / max|ref|"""
    return max(float((g.double() - r.double()).abs().max()
                     / r.double().abs().max().clamp_min(1e-300))
               for g, r in zip(as_tuple(got), as_tuple(ref)))


def f64_record(err, ms, plain_ms, moved, ops):
    """a kernel's record with its bound from the FP64 rate"""
    rec = record(err, ms, plain_ms, moved, 0)
    by_ops = ops / PEAK_F64 * 1e3
    if by_ops > rec['bound_ms']:
        rec.update(bound_ms=by_ops, bound_by="operations")
    return rec


def phase_compare_f64(dev):
    """17(a): the f64 lattice kernels (paint with a mass mesh, readouts of
    one and three meshes and 'all') at N^3 for nv 3 and 5, nv 7 (the f32
    kernels' run-time width) at WIDE_N^3 and N^3, the x-halo forms on an
    F64_SLAB_ROWS-row
    slab of N^3 (paint, three-mesh readout, rebase), and the f64 rebase
    at N^3 (K = 2 -> 2 and -> 3 with velocities), each against its plain
    version on the same tensors (1e-12 of max, the rebase bitwise), kernel
    ms beside plain ms and the bound (bytes / 3.35 TB/s or operations /
    34 TFLOP/s FP64).  Returns {kernel: record} of the main path's case
    (nv 3, K = 2 -> 2)"""
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.ops import binned_cuda
    from pmesh_tpu_torch.ops import gridpm as gp
    from pmesh_tpu_torch.ops import gridpm_cuda
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    f8 = torch.float64
    records, fails = {}, []

    def uni(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev,
                                           dtype=f8)

    def check(name, label, fn, moved, ops, bitwise=False):
        got = fn('cuda')
        ref, plain_ms = timed_once(lambda: fn('torch'))
        ms = cuda_ms(lambda: fn('cuda'), 3)
        abs_err = max_abs_diff(got, ref)
        if bitwise:
            ok, err = bitwise_equal(got, ref), abs_err
        else:
            err = rel_max(got, ref)
            ok = err <= TOL_F64
        rec = f64_record(abs_err, ms, plain_ms, moved, ops)
        log("phase 17(a) f64 %s %s: %s %.3e (tol %s), kernel %.3f ms, plain "
            "%.3f ms, bound %.3f ms (%s), on %s %s"
            % (name, label, "max|k-p|" if bitwise else "max|k-p|/max|p|",
               err, "bitwise" if bitwise else "%.0e" % TOL_F64, ms, plain_ms,
               rec['bound_ms'], rec['bound_by'], CARD,
               "ok" if ok else "FAIL"))
        if not ok:
            fails.append("%s %s" % (name, label))
        return rec

    for bounds in F64_BOUNDS:
        shape = (N,) * 3
        disp = tuple(uni(shape, *bounds) for _ in range(3))
        mass = 1.0 + 0.2 * torch.randn(shape, generator=gen, device=dev,
                                       dtype=f8)
        meshes = tuple(torch.randn(shape, generator=gen, device=dev,
                                   dtype=f8) for _ in range(3))
        vmin, vmax = gp.offset_range(*bounds, 'cic')
        nv, pts = vmax - vmin + 1, N ** 3
        label = "%d^3 CIC bounds %s nv %d" % (N, bounds, nv)
        cases = {
            "paint_lattice_f64": (
                lambda impl: gp.paint_grid(disp, mass, bounds, impl=impl),
                nbytes(disp, mass) + pts * 8, paint_ops(nv, pts, True)),
            "readout_lattice_f64": (
                lambda impl: gp.readout_grid(meshes[0], disp, bounds,
                                             impl=impl),
                nbytes(disp, meshes[0]) + pts * 8, readout_ops(nv, pts)),
            "readout_lattice_f64 (3 meshes)": (
                lambda impl: gp.readout_grid(meshes, disp, bounds,
                                             impl=impl),
                nbytes(disp, meshes) + 3 * pts * 8,
                readout_ops(nv, pts, 3)),
            "readout_lattice_f64 'all'": (
                lambda impl: gp.readout_grid(meshes[0], disp, bounds,
                                             diffdir='all', impl=impl),
                nbytes(disp, meshes[0]) + 3 * pts * 8,
                readout_ops(nv, pts, diff_all=True))}
        for name, (fn, moved, ops) in cases.items():
            rec = check(name, label, fn, moved, ops)
            if bounds == F64_BOUNDS[0] and name in KERNELS:
                records[name] = rec
        if bounds == F64_BOUNDS[0]:
            # the x-halo forms on a slab of F64_SLAB_ROWS rows
            rows = F64_SLAB_ROWS
            lo, hi = max(0, vmax), max(0, -vmin)
            dext = tuple(d[:lo + rows + hi] for d in disp)
            mext = mass[:lo + rows + hi]
            spts = rows * N * N
            records["paint_lattice_xhalo_f64"] = check(
                "paint_lattice_xhalo_f64", "%d-row slab of %d^3 nv %d"
                % (rows, N, nv),
                lambda impl: gridpm_cuda.paint_lattice(
                    dext, mext, vmin, vmax, 'cic', rows=rows, xbase=lo)
                if impl == 'cuda' else gp.paint_slab_plain(
                    dext, mext, lo, rows, bounds, 'cic'),
                nbytes(dext, mext) + spts * 8, paint_ops(nv, spts, True))
            lo, hi = max(0, -vmin), max(0, vmax)
            mx = tuple(m[:lo + rows + hi] for m in meshes)
            rd = tuple(d[:rows].contiguous() for d in disp)
            records["readout_lattice_xhalo_f64"] = check(
                "readout_lattice_xhalo_f64", "%d-row slab of %d^3 nv %d, "
                "3 meshes" % (rows, N, nv),
                lambda impl: gridpm_cuda.readout_lattice(
                    mx, rd, vmin, vmax, 'cic', xbase=lo)
                if impl == 'cuda' else gp.readout_slab_plain(
                    mx, rd, lo, bounds, 'cic'),
                nbytes(mx, rd) + 3 * spts * 8, readout_ops(nv, spts, 3))
            del dext, mext, mx, rd
        del disp, mass, meshes
        torch.cuda.empty_cache()
    # nv 7, gravpm's lattice width at 2048 Mpc/h
    bounds = WIDE_BOUNDS
    for n in (WIDE_N, N):
        shape = (n,) * 3
        disp = tuple(uni(shape, *bounds) for _ in range(3))
        meshes = tuple(torch.randn(shape, generator=gen, device=dev,
                                   dtype=f8) for _ in range(3))
        vmin, vmax = gp.offset_range(*bounds, 'cic')
        nv, pts = vmax - vmin + 1, n ** 3
        label = "%d^3 CIC bounds %s nv %d" % (n, bounds, nv)
        check("paint_lattice_f64", label,
              lambda impl: gp.paint_grid(disp, None, bounds, impl=impl),
              nbytes(disp) + pts * 8, paint_ops(nv, pts))
        check("readout_lattice_f64 (3 meshes)", label,
              lambda impl: gp.readout_grid(meshes, disp, bounds, impl=impl),
              nbytes(disp, meshes) + 3 * pts * 8, readout_ops(nv, pts, 3))
        del disp, meshes
        torch.cuda.empty_cache()
    # the rebase, bitwise
    for bounds, fill, kout in F64_REBASE:
        drift = min(0.05 - bounds[0], bounds[1] - 0.95)
        dslots, vslots, valid = rebase_state(dev, gen, N, drift, fill)
        dslots, vslots = (tuple(tuple(x.double() for x in s) for s in t)
                          for t in (dslots, vslots))
        valid = tuple(v.double() for v in valid)
        offsets = bn._drift_offsets(bounds, 3)
        lo, hi = offsets[0][0], offsets[-1][0]
        label = "%d^3 K=%d->%d bounds %s" % (N, len(fill), kout, bounds)
        routes = binned_cuda.rebase_assign(dslots, valid, kout, lo, hi)[2]
        rec_a = check(
            "rebase_assign_f64", label,
            lambda impl: binned_cuda.rebase_assign(dslots, valid, kout, lo,
                                                   hi)
            if impl == 'cuda' else bn.rebase_assign_plain(dslots, valid,
                                                          offsets, kout),
            nbytes(dslots, valid) + N ** 3 * kout * (4 * 8 + 2),
            REBASE_OPS * len(fill) * N ** 3, bitwise=True)
        rec_p = check(
            "rebase_apply_f64", label,
            lambda impl: binned_cuda.rebase_apply((vslots,), routes, lo, hi)
            if impl == 'cuda' else bn.rebase_apply_plain((vslots,), routes,
                                                         offsets),
            nbytes(vslots, routes) + N ** 3 * kout * 3 * 8, 0, bitwise=True)
        if kout == len(fill):
            records["rebase_assign_f64"], records["rebase_apply_f64"] = \
                rec_a, rec_p
            # the x-halo form on a slab of F64_SLAB_ROWS rows
            rows, xb = F64_SLAB_ROWS, max(0, hi)
            ext = tuple(tuple(x[:xb + rows - lo] for x in s) for s in dslots)
            vext = tuple(v[:xb + rows - lo] for v in valid)
            eext = tuple(tuple(x[:xb + rows - lo] for x in s)
                         for s in vslots)
            srt = binned_cuda.rebase_assign(ext, vext, kout, lo, hi,
                                            rows=rows, xbase=xb)[2]
            spts = rows * N * N
            records["rebase_assign_xhalo_f64"] = check(
                "rebase_assign_xhalo_f64", "%d-row slab of %s" % (rows,
                                                                  label),
                lambda impl: binned_cuda.rebase_assign(
                    ext, vext, kout, lo, hi, rows=rows, xbase=xb)
                if impl == 'cuda' else bn.rebase_assign_plain(
                    ext, vext, offsets, kout, rows=rows, xbase=xb),
                nbytes(ext, vext) + spts * kout * (4 * 8 + 2),
                REBASE_OPS * len(fill) * spts, bitwise=True)
            records["rebase_apply_xhalo_f64"] = check(
                "rebase_apply_xhalo_f64", "%d-row slab of %s" % (rows, label),
                lambda impl: binned_cuda.rebase_apply(
                    (eext,), srt, lo, hi, xbase=xb)
                if impl == 'cuda' else bn.rebase_apply_plain(
                    (eext,), srt, offsets, xbase=xb),
                nbytes(eext, srt) + spts * kout * 3 * 8, 0, bitwise=True)
            del ext, vext, eext, srt
        del dslots, vslots, valid, routes
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError("phase 17(a): the f64 kernels disagree with "
                             "their plain versions: %s" % ", ".join(fails))
    return records


def f8_lattice_run(solver, dlinear, steps):
    S, V = solver.lpt_lattice(dlinear, A0, order=2)
    return solver.nbody_lattice(S, V, steps, BOUNDS)


def f8_state_gap(got, ref):
    """max over the tensors of max|got - ref| / max|ref|"""
    return rel_max(got, ref)


def phase_main_f8(dev, step_ms32):
    """17(b): phase 4's path in f8 at N^3, fft='xla': lpt_lattice and 5
    KDK steps of nbody_lattice on the f64 kernels (counters read around
    it), against the same run with the plain route on the card (1e-10 of
    max), finite, a paint of it conserving mass (1e-12); ms per KDK step
    beside phase 4's f32; a superstep of nbody_binned at N^3, K = 2 (two
    KDK steps and an f64 rebase) held the same way; one fft='mxu' force
    of the f8 density (cast to f32 at the pass boundary) against the f8
    xla force.  Returns the launches of the lattice and binned runs"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    from pmesh_tpu_torch.ops import gridpm as gp
    pm = ParticleMesh([N] * 3, BoxSize=BOX, dtype='f8', resampler='cic',
                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dlinear = linear_field(pm, gen)
    solver = Solver(pm)
    nsteps = len(STEPS) - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    (S, V), ms = timed_once(lambda: f8_lattice_run(solver, dlinear, STEPS))
    launches = {k: v for k, v in counters().items() if v}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with plain_route():
        (S2, V2), plain_ms = timed_once(lambda: f8_lattice_run(
            solver, dlinear, STEPS))
    gap = f8_state_gap(S + V, S2 + V2)
    del S2, V2
    finite = all(bool(torch.isfinite(x).all()) for x in S + V)
    mass = float(gp.paint_grid(S, bounds=BOUNDS).sum())
    mass_err = abs(mass - N ** 3) / N ** 3
    t1 = cuda_ms(lambda: f8_lattice_run(solver, dlinear, STEPS[:2]), 1)
    step_ms = (ms - t1) / (nsteps - 1)
    lattice_ok = (finite and gap <= TOL_F8 and mass_err <= TOL_F8_MASS
                  and set(launches) == {"paint_lattice_f64",
                                        "readout_lattice_f64"}
                  and launches["paint_lattice_f64"]
                  == launches["readout_lattice_f64"] == nsteps + 1)
    log("phase 17(b) main path in f8 on %s: %d^3 cic fft='xla', "
        "lpt_lattice(order=2) + nbody_lattice %d KDK steps in %.3f ms (plain "
        "route on the card %.3f ms), launches %s (need paint and readout "
        "f64 %d each), against the plain route max|d|/max = %.3e (tol "
        "%.0e), finite %s, mass error %.3e (tol %.0e), peak %.2f GB; %.3f ms "
        "per KDK step (phase 4's f32: %.3f ms) %s"
        % (CARD, N, nsteps, ms, plain_ms, json.dumps(launches), nsteps + 1,
           gap, TOL_F8, finite, mass_err, TOL_F8_MASS, peak_gb, step_ms,
           step_ms32, "ok" if lattice_ok else "FAIL"))
    # one fft='mxu' force of the f8 density: the passes take it cast to
    # f32 (the JAX package's cast), so it is the f32 density's force
    rho = gp.paint_grid(S, bounds=BOUNDS)
    del S, V
    f_mxu = solver._mxu_force_raw(rho, (None, None))
    mxu_ms = cuda_ms(lambda: solver._mxu_force_raw(rho, (None, None)), 3)
    f_32 = solver._mxu_force_raw(rho.float(), (None, None))
    f_xla = solver._spectral_meshes(rho, 'xla')
    mxu_gap = rel_max(f_mxu, f_xla)
    cast_same = all(torch.equal(a, b) for a, b in zip(f_mxu, f_32))
    mxu_ok = (cast_same and mxu_gap <= 1e-4
              and all(f.dtype == torch.float32 for f in f_mxu))
    log("phase 17(b) fft='mxu' force of the f8 density: %.3f ms, dtype %s, "
        "bitwise the f32 density's %s, against the f8 fft='xla' force "
        "max|d|/max = %.3e (tol 1e-4) %s"
        % (mxu_ms, f_mxu[0].dtype, cast_same, mxu_gap,
           "ok" if mxu_ok else "FAIL"))
    del rho, f_mxu, f_32, f_xla, dlinear
    torch.cuda.empty_cache()
    # the binned superstep, K = 2, an f64 rebase between its two steps
    shape = (N,) * 3
    disp = tuple(0.05 + 0.9 * torch.rand(shape, generator=gen, device=dev,
                                         dtype=torch.float64)
                 for _ in range(3))
    vel = tuple(0.02 * torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float64) for _ in range(3))
    s = Solver(ParticleMesh([N] * 3, float(N), dtype='f8', device=dev))
    reset_counters()
    out, bms = timed_once(lambda: s.nbody_binned(disp, vel, SUPERSTEP_STEPS,
                                                 **BINNED_KW))
    blaunches = {k: v for k, v in counters().items() if v}
    ds, vs, va, ov = out
    del out
    with plain_route():
        (ds2, vs2, va2, ov2), bplain = timed_once(lambda: s.nbody_binned(
            disp, vel, SUPERSTEP_STEPS, **BINNED_KW))
    bgap = f8_state_gap(sum(ds + vs, ()) + va, sum(ds2 + vs2, ()) + va2)
    del ds2, vs2, va2, disp, vel
    count = int(bn.occupancy(va)[0])
    bmass = float(bn.paint_binned(ds, va, bounds=(-1.0, 2.0)).sum())
    bfinite = all(bool(torch.isfinite(x).all()) for x in sum(ds + vs, ()))
    binned_ok = (bgap <= TOL_F8 and int(ov) == int(ov2) == 0
                 and count == N ** 3 and bfinite
                 and abs(bmass - N ** 3) / N ** 3 <= TOL_F8_MASS
                 and set(blaunches) == {"paint_lattice_f64",
                                        "readout_lattice_f64",
                                        "rebase_assign_f64",
                                        "rebase_apply_f64"})
    log("phase 17(b) binned superstep in f8 on %s: %d^3 K=%d, 2 KDK steps + "
        "1 f64 rebase in %.3f ms (plain route on the card %.3f ms), "
        "launches %s, against the plain route max|d|/max = %.3e (tol %.0e), "
        "overflow %d, particles %d of %d, mass error %.3e, finite %s %s"
        % (CARD, N, len(ds), bms, bplain, json.dumps(blaunches), bgap,
           TOL_F8, int(ov), count, N ** 3, abs(bmass - N ** 3) / N ** 3,
           bfinite, "ok" if binned_ok else "FAIL"))
    del ds, vs, va, s, solver
    torch.cuda.empty_cache()
    if not (lattice_ok and mxu_ok and binned_ok):
        raise AssertionError("phase 17(b): the f8 paths failed their "
                             "checks")
    return launches, blaunches


def phase_grad_f8(dev):
    """17(c): phase 4d's loss in f8 at F8_GRAD_N^3 (its 2 KDK steps from
    the LPT state of the same linear field), its gradient on the f64
    kernels; <grad L, v> along a seeded v against the f8 central
    difference of L.  With TSC (a continuous derivative window) the
    difference of step F8_FD_EPS is held to TOL_F8_GRAD.  With CIC it
    cannot be: a particle whose displacement lies within the step of a
    cell boundary along v puts an O(1) error into its term (the slope of
    its weight jumps there), and at 256^3 some thousands do at any step
    the f8 loss resolves; the CIC gap is printed at F8_FD_EPS and 1e-7
    and held to TOL_F8_GRAD_CIC"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    n = F8_GRAD_N
    pm = ParticleMesh([n] * 3, BoxSize=BOX * n / N, dtype='f8',
                      resampler='cic', device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dlinear = linear_field(pm, gen)
    ok = True
    for window in ('cic', 'tsc'):
        solver = Solver(pm, force_resampler=window)
        state = sum(solver.lpt_lattice(dlinear, A0, order=2), ())
        v = tuple(torch.randn(x.shape, generator=gen, device=dev,
                              dtype=torch.float64) for x in state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        g, ms = timed_once(lambda: grad_run(solver, state, GRAD_STEPS,
                                            'xla'))
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = {k: c for k, c in counters().items() if c}
        dot = sum(float((a * b).sum()) for a, b in zip(g, v))

        def loss(step):
            with torch.no_grad():
                return float(grad_run(solver, tuple(
                    x + step * d for x, d in zip(state, v)), GRAD_STEPS,
                    'xla', backward=False))
        gaps = {}
        for eps in ((F8_FD_EPS,) if window == 'tsc' else (F8_FD_EPS,
                                                            1e-7)):
            fd = (loss(eps) - loss(-eps)) / (2 * eps)
            gaps[eps] = abs(dot - fd) / abs(dot)
        tol = TOL_F8_GRAD if window == 'tsc' else TOL_F8_GRAD_CIC
        good = (min(gaps.values()) <= tol
                and all(bool(torch.isfinite(x).all()) for x in g)
                and set(launches) == {"paint_lattice_f64",
                                      "readout_lattice_f64"})
        ok = ok and good
        log("phase 17(c) f8 gradient on %s, %s: %d^3, d/d(disp, vel) of "
            "sum(S^2 + 2 V^2) after %d KDK steps, forward + backward %.3f ms "
            "on the f64 kernels (launches %s), peak %.2f GB; <grad L, v> = "
            "%.12e against the central difference: gap %s (tol %.0e) %s"
            % (CARD, window.upper(), n, len(GRAD_STEPS) - 1, ms,
               json.dumps(launches), peak_gb, dot,
               ", ".join("%.3e at step %g" % (gp_, e)
                         for e, gp_ in gaps.items()), tol,
               "ok" if good else "FAIL"))
        del g, state, v, solver
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("phase 17(c): the f8 gradient disagrees with "
                             "the central difference")


def f8_small_runs(device, n=32):
    """force_lattice, lpt_lattice + 3 KDK steps of nbody_lattice and
    phase 7's adaptive binned run at n^3 in f8 on ``device``, and the
    launch counters of the lattice and binned runs (none on the CPU)"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    rng = np.random.RandomState(SEED)
    pm = ParticleMesh([n] * 3, BoxSize=2.0 * n, dtype='f8', device=device)
    noise = pm.create(type='real', value=torch.from_numpy(
        rng.normal(size=(n,) * 3)).to(pm.device))
    dlin = noise.r2c().apply(lambda k, v: 0.5 * v * torch.where(
        k.normp(2) > 0, k.normp(2, zeromode=1.0) ** -0.75, 0.0))
    s = Solver(pm)
    out = {}
    reset_counters()
    S, V = s.lpt_lattice(dlin, 0.1, order=2)
    out['force'] = s.force_lattice(S, BOUNDS)
    S, V = s.nbody_lattice(S, V, np.linspace(0.1, 0.2, 4), BOUNDS)
    out['lattice'] = S + V
    out['lattice_launches'] = {k: v for k, v in counters().items() if v}
    reset_counters()
    disp = rng.uniform(-0.6, 1.6, (3,) + (n,) * 3)
    vel = 0.3 * rng.normal(size=(3,) + (n,) * 3)
    ds, vs, va, ov = s.nbody_binned(
        tuple(torch.from_numpy(x).to(pm.device) for x in disp),
        tuple(torch.from_numpy(x).to(pm.device) for x in vel),
        np.linspace(0.5, 0.6, 5), nslots=1, rebase_every=2,
        step_drift=0.5, adaptive=True)
    out['binned'] = sum(ds + vs, ()) + tuple(va)
    out['overflow'] = int(ov)
    out['binned_launches'] = {k: v for k, v in counters().items() if v}
    return out


def lattice_2d(device, n, steps=4):
    """a 2-d f8 lattice run (n^2): seeded displacements and velocities,
    nbody_lattice over steps - 1 KDK steps"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.models.fastpm import Solver
    gen = torch.Generator().manual_seed(SEED + 3)
    disp = tuple(0.6 * torch.rand((n, n), generator=gen,
                                  dtype=torch.float64) - 0.3
                 for _ in range(2))
    vel = tuple(0.05 * torch.randn((n, n), generator=gen,
                                   dtype=torch.float64) for _ in range(2))
    pm = ParticleMesh([n] * 2, BoxSize=float(n), dtype='f8', device=device)
    S, V = Solver(pm).nbody_lattice(
        tuple(d.to(pm.device) for d in disp),
        tuple(v.to(pm.device) for v in vel), np.linspace(0.2, 0.5, steps),
        (-1.0, 1.0))
    return S + V


def phase_small_f8(dev):
    """17(d): f8 force_lattice, nbody_lattice and nbody_binned at 32^3 on
    the f64 kernels against the CPU (1e-10 of max); a 2-d lattice run at
    TWO_D[0]^2 on the card (the plain route, no launch) against the CPU,
    and at TWO_D[1]^2 on the card alone, timed"""
    got, ref = f8_small_runs(dev), f8_small_runs('cpu')
    gaps = {key: max(rel_ref(g.cpu(), r) for g, r in zip(got[key], ref[key]))
            for key in ('force', 'lattice', 'binned')}
    ok = (all(v <= TOL_F8 for v in gaps.values())
          and len(got['binned']) == len(ref['binned'])
          and got['overflow'] == ref['overflow'] == 0
          and set(got['lattice_launches']) == {"paint_lattice_f64",
                                               "readout_lattice_f64"}
          and set(got['binned_launches']) == {
              "paint_lattice_f64", "readout_lattice_f64",
              "rebase_assign_f64", "rebase_apply_f64"})
    log("phase 17(d) f8 32^3 card against CPU: force_lattice %.3e, "
        "nbody_lattice %.3e, nbody_binned (adaptive, K %d) %.3e (tol %.0e); "
        "launches lattice %s, binned %s %s"
        % (gaps['force'], gaps['lattice'], len(got['binned']) // 7,
           gaps['binned'], TOL_F8,
           json.dumps(got['lattice_launches']),
           json.dumps(got['binned_launches']), "ok" if ok else "FAIL"))
    n = TWO_D[0]
    reset_counters()
    g2 = lattice_2d(dev, n)
    launched = {k: v for k, v in counters().items() if v}
    r2 = lattice_2d('cpu', n)
    gap2 = max(rel_ref(g.cpu(), r) for g, r in zip(g2, r2))
    finite = all(bool(torch.isfinite(x).all()) for x in g2)
    ok2 = finite and launched == {} and gap2 <= TOL_F8
    big = TWO_D[1]
    reset_counters()
    ms = cuda_ms(lambda: lattice_2d(dev, big), 1)
    big_launched = {k: v for k, v in counters().items() if v}
    ok2 = ok2 and big_launched == {}
    log("phase 17(d) 2-d f8 lattice (3 KDK steps): %d^2 card against CPU "
        "%.3e (tol %.0e), finite %s, kernel launches %s (need none: the "
        "plain route, as the JAX package's XLA); %d^2 on %s %.3f ms, "
        "launches %s %s"
        % (n, gap2, TOL_F8, finite, json.dumps(launched), big, CARD, ms,
           json.dumps(big_launched), "ok" if ok2 else "FAIL"))
    if not (ok and ok2):
        raise AssertionError("phase 17(d): the f8 or 2-d runs failed")


def access_field(pm8, n, dtype, seed=SEED + 21):
    """the seeded global field of 17(e) on the host and this rank's
    RealField block of it"""
    gen = torch.Generator().manual_seed(seed)
    whole = torch.randn((n,) * 3, generator=gen, dtype=dtype)
    block = whole[tuple(slice(lo, hi) for lo, hi in pm8.local_block('real'))]
    return whole, pm8.create(type='real', value=block.contiguous().to(
        pm8.device))


def access_indices(n, count=ACCESS_INDEX):
    """seeded global indices of the half spectrum, each with its dual"""
    rng = np.random.RandomState(SEED + 22)
    out = []
    for _ in range(count):
        i = tuple(int(k) for k in rng.randint(0, n, 3))
        out += [i, tuple((n - k) % n for k in i)]
    return out


def access_set(pm8, n, dtype, procmesh=None):
    """17(e) on each rank (or on one device): every method of item 8d on
    the seeded field, each call timed with the bytes the collectives
    staged through the host; the exact checks against the host copy of
    the field made here (ravel, unravel, ctranspose, the untransposed
    layout against the gathered spectrum), the rest returned for the
    parent (cgetitem values, preview, the resample's block)"""
    from pmesh_tpu_torch.parallel.comm import STAGED_BYTES, reset_staged
    whole, r = access_field(pm8, n, dtype)
    calls, checks, out = {}, {}, {}

    def call(name, fn):
        if procmesh is not None:
            synced(procmesh)
        elif pm8.device.type == 'cuda':
            torch.cuda.synchronize(pm8.device)
        reset_staged()
        t0 = time.perf_counter()
        y = fn()
        if pm8.device.type == 'cuda':
            torch.cuda.synchronize(pm8.device)
        calls[name] = dict(ms=(time.perf_counter() - t0) * 1e3,
                           staged=STAGED_BYTES["to_host"]
                           + STAGED_BYTES["to_device"])
        return y
    T = call('r2c', r.r2c)
    flat = call('ravel', r.ravel)
    nl = -(-n ** 3 // (procmesh.size if pm8.sharded else 1))
    lo = nl * procmesh.rank if pm8.blocked else 0
    checks['ravel'] = bool(torch.equal(flat.cpu(), whole.reshape(-1)[
        lo:lo + flat.shape[0]]))
    back = pm8.create(type='real')
    call('unravel', lambda: back.unravel(flat))
    checks['unravel'] = bool(torch.equal(back.value, r.value))
    cflat = call('ravel (complex)', T.ravel)
    spec = pm8._whole(T.value, 'complex')
    clo = -(-T.csize // procmesh.size) * procmesh.rank if pm8.blocked \
        else 0
    checks['ravel_complex'] = bool(torch.equal(cflat, spec.reshape(-1)[
        clo:clo + cflat.shape[0]]))
    cback = call('unravel (complex)', lambda: pm8.unravel('complex', cflat))
    checks['unravel_complex'] = bool(torch.equal(cback.value, T.value))
    # block b of the points in C order on any sharded route
    coords = pm8.mesh_coordinates(dtype='i8')
    first = nl * procmesh.rank if pm8.sharded else 0
    checks['mesh_coordinates'] = bool(torch.equal(
        (coords[:, 0] * n + coords[:, 1]) * n + coords[:, 2],
        torch.arange(first, first + len(coords), device=coords.device)))
    t = call('ctranspose', lambda: r.ctranspose((2, 0, 1)))
    checks['ctranspose'] = bool(torch.equal(t.value.cpu(), whole.permute(
        2, 0, 1)[t.slices]))
    U = pm8.create(type='untransposedcomplex')
    call('r2c(out=U)', lambda: r.r2c(out=U))
    checks['U'] = bool(torch.equal(U.value, spec[U.slices]))
    T2 = call('cast U->T', lambda: U.cast(type='transposedcomplex'))
    checks['U->T'] = bool(torch.equal(T2.value, T.value))
    U2 = call('cast T->U', lambda: T.cast(type='untransposedcomplex'))
    checks['T->U'] = bool(torch.equal(U2.value, U.value))
    back = call('c2r from U', U.c2r)
    out['U_c2r_gap'] = float((back.value - r.value).abs().max()
                             / r.value.abs().max())
    index = access_indices(n)
    out['cget'] = call('cgetitem x%d' % len(index),
                       lambda: [T.cgetitem(i) for i in index])
    s = T.copy()
    sets = [(i, complex(1.0 + k, -0.5 * k))
            for k, i in enumerate(index[0::2][:4])]
    out['cset_ret'] = call('csetitem x%d' % len(sets),
                           lambda: [s.csetitem(i, y) for i, y in sets])
    got = [s.cgetitem(i) for i, _ in sets]
    checks['csetitem'] = all(g == y for g, (_, y) in zip(got, sets)) and \
        out['cset_ret'] == [y for _, y in sets]
    checks['csetitem_dual'] = all(
        s.cgetitem(tuple((n - k) % n for k in i)) == np.conj(y)
        for i, y in sets)
    out['preview'] = call('preview', lambda: r.preview(axes=(0, 1)))
    o = pm8.reshape(n // 2).create(type='real')
    call('resample', lambda: r.resample(o))
    out['resample'] = dict(value=o.value.cpu().numpy(),
                           at=o.pm.local_block('real'))
    out.update(calls=calls, checks=checks, route=pm8.route)
    return out


def card_access(pm, n, dtype):
    """17(e) on each rank: access_set at n^3 of ``dtype``; on the 4 slab
    ranks of the 512^3 job also the f8 sharded lattice and binned runs
    (card_f8_sharded), whose x-halo f64 launches the kernels line counts"""
    from pmesh_tpu_torch import ParticleMesh
    torch.cuda.reset_peak_memory_stats(pm.device)
    pm8 = ParticleMesh([n] * 3, BoxSize=float(n) if n != ACCESS_N
                       else CAT_BOX, dtype=dtype, procmesh=pm)
    rec = access_set(pm8, n, torch.float64 if dtype == 'f8'
                     else torch.float32, procmesh=pm)
    torch.cuda.empty_cache()
    if n == ACCESS_N:
        rec['f8'] = card_f8_sharded(pm, ACCESS_SHARDED_N)
    rec['peak_gb'] = torch.cuda.max_memory_allocated(pm.device) / 2 ** 30
    return rec


def card_f8_sharded(pm, n):
    """the f8 lattice path (lpt_lattice + 3 KDK steps) and a binned
    superstep at n^3 on the slab ranks, on the x-halo f64 kernels; rank 0
    holds the gathered state and density against the one-device card
    runs (1e-10 of max)"""
    from pmesh_tpu_torch import ComplexField, ParticleMesh
    from pmesh_tpu_torch import convert
    from pmesh_tpu_torch.models.fastpm import Solver
    from pmesh_tpu_torch.ops import binned as bn
    gen = torch.Generator(device=pm.device).manual_seed(SEED + 23)
    box = BOX * n / N
    pm1 = ParticleMesh([n] * 3, box, dtype='f8', device=pm.device)
    dl1 = linear_field(pm1, gen)
    solver = Solver(ParticleMesh([n] * 3, box, dtype='f8', procmesh=pm))
    dk = solver.pm.create(type=ComplexField, value=convert.to_slabs(
        dl1.value, pm, axis=1))
    (S, V), lat = timed_run(pm, lambda: f8_lattice_run(solver, dk,
                                                      ACCESS_STEPS))
    got = convert.gather(S + V, pm, dst=0)
    del S, V
    shape = (n,) * 3
    disp = tuple(0.05 + 0.9 * torch.rand(shape, generator=gen,
                                         device=pm.device,
                                         dtype=torch.float64)
                 for _ in range(3))
    vel = tuple(0.02 * torch.randn(shape, generator=gen, device=pm.device,
                                   dtype=torch.float64) for _ in range(3))
    ld, lv = convert.to_slabs((disp, vel), pm)
    (ds, vs, va, ov), sup = timed_run(pm, lambda: solver.nbody_binned(
        ld, lv, SUPERSTEP_STEPS, **BINNED_KW))
    rho = bn.paint_binned(ds, va, bounds=(-1.0, 2.0), procmesh=pm)
    bgot = convert.gather(rho, pm, dst=0)
    rec = dict(launches={k: v for k, v in lat['launches'].items() if v},
               binned_launches={k: v for k, v in sup['launches'].items()
                                if v},
               lattice_ms=lat['seconds'] * 1e3,
               binned_ms=sup['seconds'] * 1e3, overflow=int(ov))
    if pm.rank == 0:
        s1 = Solver(pm1)
        S1, V1 = f8_lattice_run(s1, dl1, ACCESS_STEPS)
        rec['lattice_gap'] = gathered_rel(got, S1 + V1)
        d1, _, va1, ov1 = s1.nbody_binned(disp, vel, SUPERSTEP_STEPS,
                                          **BINNED_KW)
        rec['binned_gap'] = gathered_rel(bgot, bn.paint_binned(
            d1, va1, bounds=(-1.0, 2.0)))
        rec['overflow_single'] = int(ov1)
    return rec


def assemble_blocks(blocks):
    """the global array from the ranks' {value, at} blocks"""
    shape = tuple(max(b['at'][d][1] for b in blocks)
                  for d in range(len(blocks[0]['at'])))
    out = np.zeros(shape, dtype=blocks[0]['value'].dtype)
    for b in blocks:
        out[tuple(slice(lo, hi) for lo, hi in b['at'])] = b['value']
    return out


def access_compare(label, out, ref, tol):
    """the ranks' 17(e) results against the one-device ``ref``; a line
    and whether every check held"""
    checks = {k: all(r['checks'][k] for r in out) for k in out[0]['checks']}
    same = all(np.array_equal(r['preview'], out[0]['preview'])
               and r['cget'] == out[0]['cget'] for r in out)
    scale = max(abs(v) for v in ref['cget'])
    cget = max(abs(a - b) for a, b in zip(out[0]['cget'], ref['cget'])) \
        / scale
    preview = float(np.abs(out[0]['preview'] - ref['preview']).max()
                    / np.abs(ref['preview']).max())
    res = assemble_blocks([r['resample'] for r in out])
    resample = float(np.abs(res - ref['resample']['value']).max()
                     / np.abs(ref['resample']['value']).max())
    uc2r = max(r['U_c2r_gap'] for r in out)
    ok = (all(checks.values()) and same and cget <= tol and preview <= tol
          and resample <= tol and uc2r <= tol)
    calls = ", ".join(
        "%s %.1f ms / %d B" % (k, max(r['calls'][k]['ms'] for r in out),
                               max(r['calls'][k]['staged'] for r in out))
        for k in out[0]['calls'])
    return ok, ("%s (route %s): exact %s; same on every rank %s; against "
                "one device: cgetitem %.3e, preview(axes=(0, 1)) %.3e, "
                "resample %.3e, c2r of U %.3e (tol %.0e); per call (slowest "
                "rank, bytes staged per rank): %s"
                % (label, out[0]['route'], json.dumps(checks), same, cget,
                   preview, resample, uc2r, tol, calls))


def phase_sharded_access(dev):
    """17(e): the field API of item 8d on gloo ranks of the card, staged
    through the host: on 4 slab ranks at phase 11's 512^3 force mesh in
    f4 against the one-device card (1e-5) with the f8 sharded lattice
    and binned runs at 64^3 beside it; on a (2, 2) pencil grid, 5 uneven
    slab ranks and 3 replicated ranks at 32^3 in f8 against the CPU
    (1e-10).  Returns the x-halo f64 launches summed over the slab ranks
    (lattice run, binned run)"""
    from pmesh_tpu_torch import ParticleMesh
    from pmesh_tpu_torch.native import cuda
    from pmesh_tpu_torch.parallel import launch
    for name in ("gridpm", "gridpm64", "binned", "fft_mxu"):
        cuda.load(name)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fails = []
    n = ACCESS_N
    one = ParticleMesh([n] * 3, BoxSize=CAT_BOX, dtype='f4', device=dev)
    ref = access_set(one, n, torch.float32)
    del one
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = launch.spawn('chip_smoke:card_access', RANKS, 'gloo', dev.type,
                       n, 'f4')
    wall = time.perf_counter() - t0
    ok, line = access_compare("%d slab ranks, %d^3 f4" % (RANKS, n), out,
                              ref, TOL_ACCESS_F4)
    log("phase 17(e) field API on %s, ranks on one card over gloo: %s; peak "
        "per rank %s GB; the job took %.3f s %s"
        % (CARD, line, " ".join("%.2f" % r['peak_gb'] for r in out), wall,
           "ok" if ok else "FAIL"))
    if not ok:
        fails.append('17(e) slab')
    lat, bin_ = {}, {}
    for r in out:
        for k, v in r['f8']['launches'].items():
            lat[k] = lat.get(k, 0) + v
        for k, v in r['f8']['binned_launches'].items():
            bin_[k] = bin_.get(k, 0) + v
    f8 = out[0]['f8']
    ok8 = (f8['lattice_gap'] <= TOL_F8 and f8['binned_gap'] <= TOL_F8
           and f8['overflow'] == f8['overflow_single'] == 0
           and set(lat) == {"paint_lattice_xhalo_f64",
                            "readout_lattice_xhalo_f64"}
           and {"rebase_assign_xhalo_f64", "rebase_apply_xhalo_f64"}
           <= set(bin_))
    log("phase 17(e) f8 on %d slab ranks at %d^3: lpt_lattice + %d KDK "
        "steps %.3f ms, launches summed %s, state against one device %.3e; "
        "binned superstep %.3f ms, launches summed %s, density against one "
        "device %.3e (tol %.0e) %s"
        % (RANKS, ACCESS_SHARDED_N, len(ACCESS_STEPS) - 1, f8['lattice_ms'],
           json.dumps(lat), f8['lattice_gap'], f8['binned_ms'],
           json.dumps(bin_), f8['binned_gap'], TOL_F8,
           "ok" if ok8 else "FAIL"))
    if not ok8:
        fails.append('17(e) f8 slabs')
    del out
    torch.cuda.empty_cache()
    m = ACCESS_SMALL
    cpu = ParticleMesh([m] * 3, BoxSize=float(m), dtype='f8', device='cpu')
    ref = access_set(cpu, m, torch.float64)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        jobs = [(label, pool.submit(launch.spawn, 'chip_smoke:card_access',
                                    world, 'gloo', dev.type, m, 'f8',
                                    shape=shape))
                for label, world, shape in (
                    ('(2, 2) pencil grid', 4, (2, 2)),
                    ('5 uneven slab ranks', 5, None),
                    ('3 replicated ranks', 3, None))]
        results = [(label, fut.result()) for label, fut in jobs]
    wall = time.perf_counter() - t0
    for label, out in results:
        ok, line = access_compare("%s, %d^3 f8" % (label, m), out, ref,
                                  TOL_F8)
        log("phase 17(e) field API on %s: %s %s"
            % (CARD, line, "ok" if ok else "FAIL"))
        if not ok:
            fails.append('17(e) ' + label)
    log("phase 17(e) the three small jobs took %.3f s" % wall)
    if fails:
        raise AssertionError("phase 17 failed its checks: %s"
                             % ", ".join(fails))
    return lat, bin_


PHASE_TIMES = []


def timed(phase, *args):
    """phase(*args), its wall time kept in PHASE_TIMES"""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_TIMES.append((phase.__name__[len("phase_"):],
                        time.perf_counter() - t0))
    return out


def main():
    import shutil
    import tempfile
    refdir = tempfile.mkdtemp(prefix="chip_smoke_rev_")
    try:
        return run_phases(refdir)
    finally:
        shutil.rmtree(refdir, ignore_errors=True)


def run_phases(refdir):
    """every phase in order; ``refdir`` carries phases 4d's and 13(a)'s
    one-device gradients to phase 16"""
    start = time.perf_counter()
    timed(phase_device)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed(phase_build)
    records = timed(phase_compare, dev)
    lattice_bf16, lattice_bf16_launches = timed(phase_compare_lattice_bf16,
                                                dev)
    records.update(lattice_bf16)
    for phase in (phase_compare_rebase, phase_compare_fft,
                  phase_compare_dense, phase_compare_ref, phase_compare_bf16,
                  phase_compare_slab):
        records.update(timed(phase, dev))
    launches, xla = timed(phase_main, dev)
    pm, dlinear = xla['pm'], xla['dlinear']
    step_ms32 = xla['step_ms']
    three_mesh = xla['three_mesh']
    mxu_launches, mxu = timed(phase_main_mxu, dev, xla)
    bf16_launches = timed(phase_main_bf16, dev, mxu)
    row13_launches, row13_bf16_launches = timed(phase_row13, dev, pm,
                                                dlinear)
    timed(phase_grad, dev, pm, dlinear, refdir)
    timed(phase_catalog_lattice, dev, pm, dlinear)
    del pm, dlinear
    catalog = timed(phase_catalog, dev)
    timed(phase_apps_catalog, dev, catalog['step_ms'])
    timed(phase_apps_lattice, dev)
    timed(phase_apps_small, dev)
    binned_launches, clustered = timed(phase_binned_clustered, dev)
    dense_bf16_launches = timed(phase_clustered_timed, clustered)
    timed(phase_binned_timed, dev)
    timed(phase_small, dev)
    for shape in (MXU_SMALL, DENSE_SMALL):
        timed(phase_small, dev, shape, np.asarray(shape, float), 'mxu')
    timed(phase_small_binned, dev)
    timed(phase_catalog_small, dev)
    timed(phase_reverse_catalog, dev, CAT_N, CAT_BOX, refdir)
    timed(phase_reverse_binned, dev)
    timed(phase_small_grad, dev, (CAT_SMALL,) * 3, 2.0 * CAT_SMALL, 'xla',
          'catalog')
    timed(phase_small_grad, dev, (32,) * 3, 32.0, 'xla', 'binned')
    timed(phase_legacy, dev)
    timed(phase_small_grad, dev, (32,) * 3, 64.0, 'xla')
    timed(phase_small_grad, dev, MXU_SMALL, np.asarray(MXU_SMALL, float),
          'mxu')
    for shape, fft in ((MXU_SMALL, 'mxu_bf16'), (MXU_SMALL, 'mxu_bf16s'),
                       (DENSE_SMALL, 'mxu_bf16')):
        timed(phase_small, dev, shape, np.asarray(shape, float), fft)
    timed(phase_small_grad, dev, MXU_SMALL,
          np.asarray(MXU_SMALL, float), 'mxu_bf16')
    sharded = timed(phase_sharded, dev)
    timed(phase_pipe_chain, dev)
    timed(phase_sharded_catalog, dev, catalog['ref'])
    timed(phase_geometries, dev, catalog.pop('ref'))
    timed(phase_sharded_reverse, dev, refdir)
    records.update(timed(phase_compare_f64, dev))
    f8_launches, f8_binned_launches = timed(phase_main_f8, dev, step_ms32)
    timed(phase_grad_f8, dev)
    timed(phase_small_f8, dev)
    xhalo_f64, xhalo_f64_binned = timed(phase_sharded_access, dev)
    # each kernel's launches on its own path's main run: the lattice
    # kernels on the fft='xla' lattice run, the ct2 DFT kernels on the
    # fft='mxu' lattice run, the rebase and dense DFT kernels on the
    # clustered binned run, the row-13 kernels on the row-13 path; their
    # bf16 forms on the mxu_bf16 and mxu_bf16s lattice runs, the
    # clustered bf16 force and the bf16 row-13 path
    runs = dict.fromkeys(("paint_lattice", "readout_lattice"), launches)
    # the three-mesh form: the spectral forces' readouts of that run,
    # counted before its gradient force
    runs["readout_lattice (3 meshes)"] = {"readout_lattice": three_mesh}
    runs.update(dict.fromkeys(("paint_lattice_bf16", "readout_lattice_bf16"),
                              lattice_bf16_launches))
    runs.update(dict.fromkeys(MXU_PER_FORCE, mxu_launches))
    runs.update(dict.fromkeys(("rebase_assign", "rebase_apply")
                              + tuple(DENSE_PER_FORCE), binned_launches))
    runs.update(dict.fromkeys(ROW13, row13_launches))
    runs.update((bf16_name(k), bf16_launches['mxu_bf16']) for k in CT2)
    runs.update((bf16_name(k, "_bf16s"), bf16_launches['mxu_bf16s'])
                for k in CT2)
    runs.update((bf16_name(k), dense_bf16_launches) for k in DENSE)
    runs.update((bf16_name(k), row13_bf16_launches) for k in ROW13)
    # the slab forms on the sharded runs, summed over the ranks: the
    # lattice ones on the fft='mxu' lattice run, row 9 on the dense
    # force, row 12 on the binned superstep
    runs.update(dict.fromkeys(("paint_lattice_xhalo",
                               "readout_lattice_xhalo"), sharded['mxu']))
    runs.update(("%s (row 9)" % k, sharded['dense']) for k in DENSE)
    runs.update(dict.fromkeys(("rebase_assign_xhalo", "rebase_apply_xhalo"),
                              sharded['superstep']))
    # the f64 forms on phase 17's f8 runs: the lattice ones on the N^3
    # lattice run, the rebase on the binned superstep, the x-halo ones on
    # the slab ranks' f8 lattice run and binned superstep, summed
    runs.update(dict.fromkeys(("paint_lattice_f64", "readout_lattice_f64",
                               "readout_lattice_f64 (3 meshes)"),
                              f8_launches))
    runs.update(dict.fromkeys(("rebase_assign_f64", "rebase_apply_f64"),
                              f8_binned_launches))
    runs.update(dict.fromkeys(("paint_lattice_xhalo_f64",
                               "readout_lattice_xhalo_f64"), xhalo_f64))
    runs.update(dict.fromkeys(("rebase_assign_xhalo_f64",
                               "rebase_apply_xhalo_f64"), xhalo_f64_binned))
    if DEFERRED:
        raise AssertionError("; ".join(DEFERRED))
    log("phase times (s): %s; main %.3f s"
        % (", ".join("%s %.3f" % kv for kv in PHASE_TIMES),
           time.perf_counter() - start))
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces,
                    launches=runs[name][name.split(" ")[0]],
                    **records[name])
               for name, (source, replaces) in KERNELS.items()]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
