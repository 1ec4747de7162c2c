"""Experiment configuration (counterpart of amg_tpu/utils/config.py): every
semantic knob of the drivers as one dataclass, with the reference's field
names, defaults and derived-flag rules (`SolverOptions.fixup`), copied
unchanged so that a set of options means the same run in both packages.
`amg_tpu_torch/utils/cli.py` exposes the same flag names.

The multi-device fields (`num_devices`, `grid_parallel`, `comm`, `imbal`,
`assign_procs*`, `converge_test_type`) are kept, since the CLI parses them;
`utils/runner.py` refuses `num_devices > 1` until the multi-device modules
are ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

# solver taxonomy of the reference (Main.hpp:60-77), native names
SYNC_SOLVERS = ("mult", "multadd", "mult_multadd", "afacx", "afacj", "bpx",
                "par_bpx")
ASYNC_SOLVERS = ("async_multadd", "async_afacx", "async_bpx",
                 # async additive auxiliary-space Maxwell (config 5's
                 # literal composition: src/Maxwell.cpp + src/DMEM_Add.cpp)
                 "async_ams")
SMOOTH_SOLVERS = ("async_smooth",)  # one-level async relaxation (finest grid)
EXT_SOLVERS = ("explicit_ext_bpx", "implicit_ext_bpx",
               "async_explicit_ext_bpx", "async_implicit_ext_bpx")
# the reference's short names (aliased to the EXT solvers in fixup)
EXT_ALIASES = ("eebpx", "iebpx", "async_eebpx", "async_iebpx")
ALL_SOLVERS = (
    SYNC_SOLVERS + ASYNC_SOLVERS + EXT_SOLVERS + SMOOTH_SOLVERS + EXT_ALIASES
)

SMOOTHERS = (
    "jacobi", "l1_jacobi", "hybrid_jgs", "gs",
    "sym_jacobi", "sym_l1_jacobi",
)

PROBLEMS = ("5pt", "7pt", "27pt", "difconv", "vardifconv", "elasticity",
            "maxwell", "graded", "amr", "file")


@dataclass
class SolverOptions:
    # problem (reference: -problem, -n, -nx/-ny/-nz, -eps, -difconv_atype)
    problem: str = "5pt"
    n: int = 32
    nx: int = 0
    ny: int = 0
    nz: int = 0
    eps: float = 1.0
    difconv_atype: int = 0
    matrix_file: str = ""  # -mat_file
    # enable the disconnected-row removal/renumber pass on file matrices
    # (reference -include_disconnected_points — the flag's name is inverted
    # relative to its behavior, src/DMEM_BuildMatrix.cpp:1284-1310)
    include_disconnected_points: bool = False
    num_functions: int = 0  # 0 = auto (problem-dependent); >0 overrides
    sigma: float = 1.0  # maxwell conductivity
    # elasticity boundary handling: "reduce" eliminates clamped dofs (SPD
    # reduced system, MFEM-style); "identity" keeps the full structured node
    # grid (clamped rows/cols zeroed, unit diagonal — same free-dof
    # solution) so the operator admits the gather-free DIA device format
    elast_bc: str = "reduce"  # reduce | identity
    grading: float = 2.5  # graded-mesh (AMR-analog) refinement exponent
    amr_rounds: int = 3  # estimator-driven refinement rounds (-problem amr)
    amr_theta: float = 0.5  # ThresholdRefiner marking fraction

    # hierarchy type: algebraic AMG or structured (geometric, PFMG-style,
    # gather-free — stencil problems only); mixed: f32 cycles refined in
    # f64 (mixed_pcg / mixed_solve)
    hierarchy: str = "algebraic"  # algebraic | structured
    mixed_precision: bool = False

    # setup (reference: -th strong threshold, -interp, -coarsen, -mxl,
    #        -agg_nl/-Pmax analogues, -smooth_weight, -num_threads→block)
    strong_threshold: float = 0.25
    coarsen_type: str = "hmis"
    interp_type: str = "ext+i"
    p_max_elmts: int = 4
    trunc_factor: float = 0.0
    max_levels: int = 25
    max_coarse_size: int = 64
    # aggressive (two-pass) coarsening on the first N levels (reference
    # -agg_nl → HYPRE_BoomerAMGSetAggNumLevels, src/DMEM_Main.cpp:517-520)
    agg_nl: int = 0
    smooth_weight: Optional[float] = None
    block_size: int = 128
    seed: int = 0
    # setup family: classical (PMIS/HMIS+ext+i) or sa (smoothed aggregation
    # with near-nullspace candidates — elasticity-class problems); "auto"
    # resolves per problem in fixup (sa for elasticity, classical otherwise)
    setup_type: str = "auto"
    # device operator format: ell | auto (the port's rule: ELL) | dia (the
    # fine DIA operator on any device); the reference's fixed-tile bsr is
    # not ported (the runner raises)
    device_format: str = "auto"

    # solver (reference: -solver, -smoother, -num_cycles, -tol, -sweeps)
    solver: str = "mult"
    smoother: str = "l1_jacobi"
    num_cycles: int = 200
    tol: float = 1e-8
    # run exactly num_cycles cycles with no per-cycle residual norm — the
    # reference's pure cycle-timing mode (-no_resnorm)
    no_resnorm: bool = False
    num_pre_smooth_sweeps: int = 1
    num_post_smooth_sweeps: int = 1
    num_fine_smooth_sweeps: int = 2
    num_coarse_smooth_sweeps: int = 2
    num_add_smooth_sweeps: int = 1
    # > 0: one value for pre/post/fine/coarse sweeps (reference
    # -num_smooth_sweeps, src/DMEM_Main.cpp:489-497)
    num_smooth_sweeps: int = 0
    simple_jacobi: bool = False  # -simple_jacobi
    one_interpolant: bool = True  # smoothed-transfer multadd chains
    # MULT_MULTADD hybrid (reference -coarsest_mult_level,
    # -num_inner_cycles): multiplicative above the level, multadd below
    coarsest_mult_level: int = 1
    num_inner_cycles: int = 2
    # AFACj ideal-interpolant depth (reference -afacj_level, default 1)
    afacj_level: int = 1
    # truncation of the additive smoothed transfers P~ (reference -add_tr →
    # hypre add_trunc_factor, src/DMEM_Main.cpp:529-531)
    add_tr: float = 0.0

    # acceleration / outer (reference: -cheby, -richard, -outer_solver pcg);
    # ams_pcg = PCG with the auxiliary-space (Hiptmair/AMS) preconditioner
    # (curl-curl problems carrying a discrete gradient in Problem.aux)
    accel: str = "none"  # none | cheby | richardson
    outer_solver: str = "none"  # none | pcg | ams_pcg
    cheby_power_iters: int = 20
    # async asymmetric acceleration: the level whose grid group keeps the
    # 3-term direction vector d (reference -cheby_grid,
    # src/DMEM_Main.cpp:705-707; clamped to num_levels-1)
    cheby_grid: int = 0
    # eig-bound estimator (reference -cheby_eig {power, hypre_lobpcg, slepc},
    # src/SMEM_Main.cpp:606-618); "lanczos" is the Krylov analog of the
    # reference's SLEPc Arnoldi path
    cheby_eig: str = "power"  # power | lobpcg | lanczos

    # async execution (reference: -sim_read_delay, -sim_grid_wait, async/semi)
    async_type: str = "full"  # full | semi
    read_type: str = "sol"  # sol | res
    sim_read_delay: int = 4
    fire_prob: float = 0.5
    # > 0: wait-counter firing drawn uniform [0, sim_grid_wait] per level,
    # the reference's SEQ_Add_Vcycle_Sim model (src/SEQ_AMG.cpp:260,482,552)
    sim_grid_wait: int = 0
    # async residual maintenance: "recompute" (true r = b - A x each
    # superstep) | "accumulate" (incremental r -= A*corrections, the
    # reference's RES_ACCUMULATE, -res_update_type src/DMEM_Main.cpp:583-590)
    res_update_type: str = "recompute"  # recompute | accumulate

    # message coalescing for the grid-parallel async exchange (the
    # reference's -async_comm_save_divisor, src/DMEM_Add.cpp:375-383)
    async_comm_save_divisor: int = 1
    # async termination scope (reference -converge_test_type local|global,
    # CheckConverge src/DMEM_Add.cpp:906-944); applies to the grid-parallel
    # async solve
    converge_test_type: str = "global"  # global | local

    # async one-level smoothing / stochastic parallel Southwell
    # (reference: -sps_alpha, -sps_rand, src/DMEM_Main.cpp:448-460)
    sps_method: str = "southwell_exp"  # fixed | southwell_exp | southwell_inv
    sps_alpha: float = 1.0
    sps_min_prob: float = 0.0  # > 0: derive alpha per block (-sps_min_prob)

    # difconv coefficients (reference -ax/-ay/-az convection velocity,
    # -cx/-cy/-cz per-axis diffusion, src/DMEM_Main.cpp CLI)
    ax: float = 1.0
    ay: float = 1.0
    az: float = 1.0
    cx: float = 1.0
    cy: float = 1.0
    cz: float = 1.0
    num_blocks: int = 8  # rank/shard analog for the async-smooth partition

    # fault / straggler injection (reference: -delay_*, -fail_one)
    delay_levels: Tuple[int, ...] = ()
    delay_prob: float = 0.5
    fail_level: int = -1
    fail_start: int = 0
    fail_duration: int = 0
    # delay-selection policy resolved against the built hierarchy's level
    # count in the runner (reference -delay_one/-delay_some/-delay_all,
    # src/SMEM_Main.cpp:572-596 / src/SMEM_Solve.cpp:108-126): "one" = the
    # last level group (the reference delays thread num_threads-1), "some" =
    # a random delay_frac fraction, "all" = every group
    delay_type: str = "none"  # none | one | some | all
    delay_frac: float = 0.0  # > 0 implies delay_type "some"
    # -fail_one <iter>: last level group misses one firing at that cycle
    fail_iter: int = -1

    # rhs / init guess (reference: -rhs_* / -init_guess_*)
    rhs: str = "rand"  # rand | ones | zeros
    init_guess: str = "zeros"

    # output (reference: -print_reshist, -oneline_output, -print_level_stats,
    #         -print_grid_wait)
    print_reshist: bool = False
    oneline_output: bool = False
    print_level_stats: bool = False
    print_grid_wait: bool = False

    # background busy-loop competitor process during the solve
    # (reference: -background_program, src/SMEM_Main.cpp:630-639)
    background_program: bool = False

    # execution target
    num_devices: int = 1  # >1: shard over a device mesh
    # multi-device async additive solves map levels to device groups (the
    # reference's grid parallelism, AssignProcs src/DMEM_Setup.cpp:1638-1759);
    # turn off to use pure row sharding instead
    grid_parallel: bool = True
    # row-sharded comm backend: "halo" ships only boundary segments per
    # matvec (the reference's comm-pkg halo exchange); "gspmd" gathers the
    # whole vector (simple baseline); multi-device only
    comm: str = "halo"
    imbal: float = 0.0  # artificial work-model imbalance (reference -imbal)
    # level→device-group sizing policy (reference -assign_procs
    # balanced|scalar + -assign_procs_scalar, src/DMEM_Main.cpp:396-425,
    # src/DMEM_Setup.cpp:1684-1685)
    assign_procs: str = "balanced"  # balanced | scalar
    assign_procs_scalar: float = 0.5
    only_setup: bool = False  # reference -only_setup
    only_build_matrix: bool = False  # reference -only_build_matrix
    print_matrix: str = ""  # dump A as binary triplets to this path
    num_runs: int = 1
    warmup: bool = False  # one discarded run first (reference -warmup)
    # iteration-sweep harness: re-run the solve at num_cycles =
    # start_num_iters, start+incr, ..., max_num_iters (reference:
    # src/SMEM_Main.cpp:108-110,694 — used with tol=0 to time fixed
    # cycle counts). max_num_iters <= 0 disables the sweep.
    start_num_iters: int = 0
    incr_num_iters: int = 1
    max_num_iters: int = 0

    def fixup(self) -> "SolverOptions":
        """Derived-flag rules, as in the reference's post-parse fixups."""
        # the reference's short extended-system solver names
        aliases = {
            "eebpx": "explicit_ext_bpx",
            "iebpx": "implicit_ext_bpx",
            "async_eebpx": "async_explicit_ext_bpx",
            "async_iebpx": "async_implicit_ext_bpx",
        }
        self.solver = aliases.get(self.solver, self.solver)
        # reference -cheby_eig spellings → native estimators
        self.cheby_eig = {
            "hypre_lobpcg": "lobpcg", "slepc": "lanczos"
        }.get(self.cheby_eig, self.cheby_eig)
        if self.solver == "par_bpx":
            # the reference's PAR_BPX = BPX flattened over the concatenated
            # multilevel vector (src/SMEM_Sync_AMG.cpp:147-294) — here that
            # IS the implicit extended system
            self.solver = "implicit_ext_bpx"
        if (
            self.solver in ("bpx", "multadd", "afacx", "afacj") + EXT_SOLVERS
            and self.accel == "none"
        ):
            # additive operators are poorly conditioned as stationary
            # iterations — the reference runs them under Chebyshev/Richardson
            # (src/DMEM_Misc.cpp:612-666); default the acceleration on so the
            # CLI defaults converge
            if self.outer_solver == "none":
                self.accel = "cheby"
        if (
            self.solver in ASYNC_SOLVERS
            and self.solver != "async_ams"  # auto-omega from AMS eig bounds
            and self.accel == "none"
        ):
            # async additive paths cannot use the global Chebyshev recurrence
            # (partial stale updates break the 3-term consistency, reference
            # keeps d only on cheby_grid, src/DMEM_Misc.cpp:612-666) — use the
            # stationary Richardson weight derived from the same eig bounds
            if self.outer_solver == "none":
                self.accel = "richardson"
        if self.solver in ASYNC_SOLVERS and self.solver.endswith("bpx"):
            self.read_type = "res"
        if self.setup_type == "auto":
            self.setup_type = (
                "sa" if self.problem == "elasticity" else "classical"
            )
        if self.problem == "elasticity" and not self.is_async():
            # classical unknown-based AMG (and even a bare SA V-cycle with
            # one L1-Jacobi sweep) is a near-unity contraction on the thin
            # beam (fine-level cond ~1e7): verified to stall at rel res ~5
            # after 200 cycles. The production recipe for elasticity-class
            # problems is the SA hierarchy on rigid-body modes used as a PCG
            # preconditioner (the reference solves its MFEM problems under an
            # outer Krylov method too, src/Elasticity.cpp + hypre PCG) — wrap
            # the multiplicative default so CLI defaults converge.
            if (
                self.outer_solver == "none"
                and self.accel == "none"
                and self.solver == "mult"
            ):
                self.outer_solver = "pcg"
        if self.problem == "maxwell" and not self.is_async():
            # curl-curl has a huge near-nullspace (discrete gradients);
            # nodal AMG alone stalls (verified: rel res 8e-3 after 200
            # cycles). The production path is the auxiliary-space AMS
            # preconditioner under PCG (hypre AMS; the reference solves
            # Maxwell through it as well) — default it on.
            if (
                self.outer_solver == "none"
                and self.accel == "none"
                and self.solver == "mult"
            ):
                self.outer_solver = "ams_pcg"
        if self.num_smooth_sweeps > 0:
            # one sweep count for all phases (reference -num_smooth_sweeps)
            self.num_pre_smooth_sweeps = self.num_smooth_sweeps
            self.num_post_smooth_sweeps = self.num_smooth_sweeps
            self.num_fine_smooth_sweeps = self.num_smooth_sweeps
            self.num_coarse_smooth_sweeps = self.num_smooth_sweeps
        if self.delay_frac > 0.0 and self.delay_type == "none":
            self.delay_type = "some"
        return self

    def is_async(self) -> bool:
        return self.solver.startswith("async_")

    def grid_dims(self):
        nx = self.nx or self.n
        ny = self.ny or self.n
        nz = self.nz or self.n
        return nx, ny, nz
