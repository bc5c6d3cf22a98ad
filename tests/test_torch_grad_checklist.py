"""The gradient checklist of the public surface: every public callable of
the JAX package (the functions, classes and methods of the modules that
``tests/test_torch_surface.py`` walks) is filed in one of three lists.

* ``GRAD_HELD``: ``jax.grad`` differentiates it, and the named port test
  holds the port's gradient (to ``jax.grad`` of the JAX package, or to
  finite differences where only the port's form exists).  A class is
  filed by what its instances offer: a plan by its call.
* ``NO_JAX_GRAD``: ``jax.grad`` gives it no gradient, with the reason:
  host numpy on its inputs (``TracerArrayConversionError``), a
  ``while_loop`` with a data-dependent trip count, an integer or boolean
  result, no float input at all, a ``pallas_call``, or a host build step.
  The port owes these no gradient.
* ``GRAD_OPEN``: ``jax.grad`` differentiates it and the port does not
  yet; each is a known fault, listed in ROADMAP.md.

The filing was made by calling ``jax.grad`` on the JAX package's own test
systems for every entry with a float input.  The tests below check that
the three lists cover the surface exactly and that every named test
exists, so that the next audit is a lookup.
"""

import ast
import importlib
import inspect
import pathlib

import pytest
import torch

from test_torch_surface import NOT_TO_PORT, _defined, _jax_modules

# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

HERE = pathlib.Path(__file__).parent

# -- the tests that hold gradients -------------------------------------------
T_GRAD = "test_torch_grad.py"
T_PLANS = "test_torch_grad_plans.py"
T_DIST = "test_torch_grad_dist.py"
T_BANDED = "test_torch_grad_banded.py"
T_SURF = "test_torch_grad_surface.py"
T_FACTOR = "test_torch_grad_factor.py"
SURF = (T_SURF, "test_surface_grad_matches_jax")


def _held(test, *names):
    return {name: test for name in names}


GRAD_HELD = {
    **_held((T_GRAD, "test_eager_product_grads_match_jax"),
            "ops.matvec.spmv", "ops.matvec.spmm"),
    **_held((T_GRAD, "test_spmv_plan_grad_matches_jax"),
            "ops.matvec.SpMVPlan"),
    **_held((T_GRAD, "test_solve_rhs_grad_matches_jax"),
            "linalg.lu.SolvePlan"),
    **_held((T_GRAD, "test_refactor_values_grad_matches_jax"),
            "linalg.refactor.RefactorPlan",
            "linalg.refactor.RefactorPlan.refactor"),
    **_held((T_GRAD, "test_refactor_solve_gradcheck"),
            "linalg.supernodal.SupernodalRefactor",
            "linalg.supernodal.SupernodalRefactor.refactor"),
    **_held((T_GRAD, "test_multifrontal_values_grad_matches_jax"),
            "linalg.multifrontal.MultifrontalRefactor",
            "linalg.multifrontal.MultifrontalRefactor.refactor"),
    **_held((T_PLANS, "test_band_plan_grads_match_jax"),
            "ops.matvec.DIAPlan", "ops.matvec.SymDIAPlan"),
    **_held((T_PLANS, "test_split_band_grads_match_jax"),
            "ops.matvec.SplitDIA", "ops.matvec.SplitSymDIA"),
    **_held((T_PLANS, "test_split_spmv_grads_match_jax"),
            "ops.matvec.SplitSpMV"),
    **_held((T_PLANS, "test_spgemm_plan_grads_match_jax"),
            "ops.spgemm.SpGEMMPlan", "ops.spgemm.SpGEMMPlan.numeric"),
    **_held((T_PLANS, "test_gram_plan_grads_match_jax"),
            "ops.spgemm.GramPlan", "ops.spgemm.GramPlan.numeric"),
    **_held((T_PLANS, "test_bsr_product_grads_match_jax"), "types.BSR"),
    **_held((T_PLANS, "test_bsr_matmat_plan_grads_match_jax"),
            "ops.bsr_ops.BSRMatMatPlan",
            "ops.bsr_ops.BSRMatMatPlan.numeric"),
    **_held((T_PLANS, "test_solve_rhs_grads_match_jax"),
            "linalg.banded.BandedLU", "linalg.banded.BandedLU.blocks",
            "linalg.banded.BandedLU.solve_blocks",
            "linalg.banded.BandedLU.unblocks",
            "linalg.banded.BandedSolvePlan",
            "linalg.banded.BandedSolvePlan.blocks",
            "linalg.banded.BandedSolvePlan.solve_blocks",
            "linalg.banded.BandedSolvePlan.unblocks",
            "linalg.cholesky.LDLTSolvePlan"),
    **_held((T_PLANS, "test_banded_refactor_grads_match_jax"),
            "linalg.banded.BandedRefactor",
            "linalg.banded.BandedRefactor.refactor"),
    # this slice: the distributed layer
    **_held((T_DIST, "test_dist_spmv_grad_matches_jax"),
            "parallel.spmv.spmv_local", "parallel.spmv.dist_spmv",
            "parallel.spmv.dist_spmm", "parallel.partition.RowPartition"),
    **_held((T_DIST, "test_jacobi_apply_local_grad_matches_jax"),
            "parallel.solve.BlockJacobi",
            "parallel.solve.BlockJacobi.apply_local",
            "parallel.solve.DiagJacobi",
            "parallel.solve.DiagJacobi.apply_local"),
    **_held((T_DIST, "test_schur_solve_grad_matches_jax"),
            "parallel.schur.SchurSolvePlan",
            "parallel.schur.SchurSolvePlan.solve",
            "parallel.schur.SchurSolvePlan.dist_solve"),
    **_held((T_DIST, "test_dist_banded_solve_blocks_grad_matches_jax"),
            "parallel.banded.DistBandedLU.solve_blocks"),
    # the device recurrences and the ESC product
    **_held((T_BANDED, "test_thomas_sweeps_grad_matches_jax"),
            "linalg.banded.thomas_sweeps", "linalg.banded.thomas_sweeps_sym"),
    **_held((T_BANDED, "test_thomas_factor_device_grad_matches_jax"),
            "linalg.banded.thomas_factor_device",
            "linalg.banded.thomas_factor_device_sym"),
    **_held((T_BANDED, "test_spike_tips_device_grad_matches_jax"),
            "linalg.banded.spike_tips_device"),
    **_held((T_BANDED, "test_spike_reduced_factor_grad_matches_jax"),
            "linalg.spike_stream.spike_reduced_factor"),
    **_held((T_BANDED, "test_esc_spgemm_grad_matches_jax"),
            "ops.spgemm_device.ESCSpGEMM"),
    # the numeric factorizations: reverse sweeps over the saved factors
    **_held((T_FACTOR, "test_factor_values_grad_matches_jax"),
            "linalg.refactor.RefactorPlan.factor_values",
            "linalg.supernodal.SupernodalRefactor.factor_values",
            "linalg.multifrontal.MultifrontalRefactor.factor_values"),
    **_held((T_FACTOR, "test_retarget_solve_plan_grad_matches_jax"),
            "linalg.refactor.retarget_solve_plan"),
    **_held((T_FACTOR, "test_factor_piv_solve_piv_grad_matches_jax"),
            "linalg.multifrontal.MultifrontalLU",
            "linalg.multifrontal.MultifrontalLU.factor_piv",
            "linalg.multifrontal.MultifrontalLU.solve_piv"),
    # the smaller entries the checklist found
    **_held(SURF,
            "ops.arithmetic.scale", "ops.arithmetic.scale_rows",
            "ops.arithmetic.scale_columns", "ops.reductions.diagonal",
            "ops.reductions.sum", "ops.norms.norm",
            "ops.construct.transpose", "ops.construct.csc_to_coo",
            "ops.construct.csc_to_csr", "ops.construct.csr_to_csc",
            "ops.construct.csc_to_dense", "ops.construct.coo_to_dense",
            "types.CSC", "types.CSC.t", "types.CSC.todense",
            "types.CSC.astype", "types.CSC.conj", "types.CSC.copy",
            "types.CSC.diagonal", "types.CSC.sum", "types.CSC.norm",
            "types.CSC.to_csr", "types.CSC.to_coo", "types.CSR",
            "types.CSR.todense", "types.CSR.to_csc", "types.COO",
            "types.COO.to_dense",
            "linalg.trisolve.TriSolvePlan",
            "linalg.trisolve.TriSolvePlan.solve",
            "linalg.trisolve.DenseTailTriSolvePlan",
            "linalg.trisolve.DenseTailTriSolvePlan.solve",
            "linalg.iterative.jacobi_prec", "linalg.iterative.ilu0_prec",
            "linalg.iterative.refine",
            "models.powerflow.sbus", "models.grids.branch_admittances",
            "models.grids.reorder_grid",
            "models.powerflow.FastDecoupled.mismatch",
            "models.powerflow.FastDecoupled.residual",
            "models.powerflow.FastDecoupled.step",
            "parallel.partition.RowPartition.pad_vector",
            "parallel.partition.RowPartition.trim_vector"),
}

# -- no JAX gradient ---------------------------------------------------------
HOST = ("host numpy or native code on its float inputs (jax.grad raises "
        "TracerArrayConversionError)")
HOST_IO = "host numpy in and out around the device solve"
BUILD = ("a host build step (symbolic analysis, ordering or factorization "
         "with numpy or native code): returns a plan or a factor object")
WHILE = ("a lax.while_loop with a data-dependent trip count: jax.grad "
         "refuses reverse mode")
INTEGER = ("integer or boolean result (a pattern, an ordering, labels, "
           "flags or sizes)")
NO_FLOAT = ("no float input: integer ids, shapes, seeds or the object's own "
            "host state")
PALLAS = "pallas_call: jax.grad refuses it (no reverse rule)"
IO = "file or text input and output"
META = "configuration, timing or measurement: no numeric function"
SPGEMM = "a sparse-sparse product through the host symbolic phase"


def _no(reason, *names):
    return {name: reason for name in names}


_BUILDERS = [f"builder.{c}{m}" for c in ("TripletBuilder", "LilMat",
                                          "CooMat")
             for m in ("", ".add", ".add_triplets", ".get_nz",
                       ".insert_or_replace", ".to_coo", ".to_csc",
                       ".to_dense", ".triplets", ".try_get")]
_HOST_EXT = [f"native.host_ext.{f}" for f in (
    "ldlt_factor", "lu_factor", "lu_factor_sn", "amd", "rcm", "nd",
    "max_transversal", "btf", "coo_to_csc", "refactor_build", "csc_spgemm",
    "csc_axpby", "csc_gram", "csc_gram_cached", "csc_gram_revalue",
    "csc_transpose")]

NO_JAX_GRAD = {
    **_no(HOST, "scipy_to_mat", *_BUILDERS, *_HOST_EXT),
    **_no(META, "config.Config", "config.get_config", "config.update",
          "config.config_ctx"),
    # the Pallas kernels (K1-K3 through SplitBandPoints; K4-K7 direct)
    **_no(PALLAS, "kernels.bandpoints.points_spmv_pallas",
          "kernels.bandpoints.band_points_spmv_pallas",
          "kernels.bandpoints.band_points_supertile_pallas",
          "kernels.bandpoints.SplitBandPoints",
          "kernels.bsr_spmm_pallas.bsr_spmm_pallas",
          "kernels.dia_pallas.dia_spmv_pallas",
          "kernels.dia_pallas.PallasDIA", "kernels.dia_pallas.SplitPallasDIA",
          "kernels.spgemm_pallas.spgemm_numeric_pallas"),
    **_no(BUILD, "kernels.bandpoints.OffsetsPlan",
          "kernels.bandpoints.OffsetsPlan.from_entries"),
    **_no(INTEGER, "kernels.bandpoints.OffsetsPlan.rows",
          "kernels.bandpoints.split_offsets"),
    # linalg
    **_no(INTEGER, "linalg.banded.bandwidth", "linalg.banded.is_symmetric_csc",
          "linalg.btf.max_transversal", "linalg.btf.btf",
          "linalg.ordering.symmetrize_pattern", "linalg.ordering.natural",
          "linalg.ordering.rcm", "linalg.ordering.mindeg",
          "linalg.ordering.amd", "linalg.ordering.nd",
          "linalg.ordering.get_ordering", "linalg.trisolve.level_schedule",
          "linalg.trisolve.choose_dense_tail"),
    **_no(HOST, "linalg.banded.BandedLU.factor_device",
          "linalg.banded.BandedLU.solve_host",
          "linalg.banded.ComplexBandedSolve",
          "linalg.banded.ComplexBandedSolve.solve",
          "linalg.btf.BTFLU", "linalg.btf.BTFLU.solve",
          "linalg.cholesky.SparseLDLT.solve",
          "linalg.cholesky.SparseLDLT.solve_host",
          "linalg.lu.SparseLU.solve", "linalg.lu.SparseLU.solve_host",
          "linalg.lu.spsolve", "linalg.lu_host.HostLU",
          "linalg.lu_host.lu_factor_host",
          "linalg.spike_stream.StreamedSPIKE",
          "linalg.spike_stream.StreamedSPIKE.solve",
          "linalg.trisolve.lsolve", "linalg.trisolve.usolve",
          "linalg.trisolve.ltsolve", "linalg.trisolve.utsolve"),
    **_no(BUILD, "linalg.banded.BandedLU.refactor_plan",
          "linalg.banded.BandedRefactor.from_matrix", "linalg.btf.btf_splu",
          "linalg.cholesky.SparseLDLT",
          "linalg.cholesky.SparseLDLT.solve_plan",
          "linalg.cholesky.ldlt", "linalg.lu.SparseLU",
          "linalg.lu.SparseLU.banded_solve_plan",
          "linalg.lu.SparseLU.refactor_plan", "linalg.lu.SparseLU.solve_plan",
          "linalg.lu.splu", "linalg.multifrontal.MultifrontalLU.from_matrix"),
    **_no(WHILE, "linalg.iterative.cg", "linalg.iterative.bicgstab",
          "linalg.iterative.gmres"),
    # models
    **_no(NO_FLOAT, "models.contingency.ACContingency",
          "models.contingency.ACContingency.run",
          "models.contingency.ACContingency.run_sharded",
          "models.contingency.DCContingency",
          "models.contingency.DCContingency.base_theta",
          "models.contingency.DCContingency.run",
          "models.contingency.DCContingency.run_sharded",
          "models.sensitivity.LinearContingency",
          "models.sensitivity.LinearContingency.run",
          "models.sensitivity.LinearContingency.run_sharded",
          "models.grids.Grid", "models.grids.ieee14",
          "models.grids.synthetic_grid", "models.estimation.SEResult",
          "models.shortcircuit.SCResult"),
    **_no(INTEGER, "models.grids.connectivity"),
    **_no(HOST, "models.estimation.DCMeasurements",
          "models.estimation.DCMeasurements.build",
          "models.estimation.dc_state_estimation",
          "models.estimation.largest_normalized_residual",
          "models.grids.ybus", "models.grids.rcm_grid",
          "models.powerflow.dc_power_flow", "models.powerflow.newton_raphson",
          "models.sensitivity.ptdf", "models.sensitivity.lodf",
          "models.shortcircuit.zbus_columns",
          "models.shortcircuit.short_circuit"),
    **_no(BUILD, "models.powerflow.FastDecoupled",
          "models.powerflow.NewtonPowerFlow"),
    **_no(WHILE, "models.powerflow.FastDecoupled.run",
          "models.powerflow.FastDecoupled.solve",
          "models.powerflow.FastDecoupled.solve_batch",
          "models.powerflow.NewtonPowerFlow.run",
          "models.powerflow.NewtonPowerFlow.solve",
          "models.powerflow.NewtonPowerFlow.solve_batch"),
    **_no(IO, "models.matpower.parse_case", "models.matpower.load_case"),
    # ops
    **_no(HOST, "ops.arithmetic.axpby", "ops.arithmetic.add",
          "ops.arithmetic.sub", "ops.arithmetic.elmul",
          "ops.arithmetic.eldiv", "ops.arithmetic.maximum",
          "ops.arithmetic.minimum", "ops.arithmetic.eliminate_zeros",
          "ops.bsr_ops.bsr_transpose", "ops.bsr_ops.bsr_add",
          "ops.bsr_ops.bsr_binop", "ops.bsr_ops.bsr_matmat",
          "ops.construct.from_triplets", "ops.construct.coo_to_csc",
          "ops.construct.real_equivalent",
          "ops.construct.complex_rhs_to_real",
          "ops.construct.real_x_to_complex", "ops.construct.canonicalize",
          "ops.construct.dense_to_csc", "ops.construct.csc_to_bsr",
          "ops.construct.bsr_to_dense", "ops.construct.diag",
          "ops.construct.diags", "ops.construct.csc_to_dia",
          "ops.construct.dia_to_csc", "ops.matvec.bsr_spmm",
          "ops.matvec.dia_spmv", "ops.reductions.sum_duplicates",
          "ops.slicing.getitem", "ops.slicing.submatrix",
          "ops.slicing.sample_values", "ops.spgemm.spgemm", "ops.spgemm.gram",
          "ops.spgemm_device.spgemm_device", "ops.spgemm_device.gram_device",
          "ops.stacking.block", "ops.stacking.hstack", "ops.stacking.vstack",
          "ops.stacking.pack_4_by_4"),
    **_no(INTEGER, "ops.arithmetic.compare", "ops.arithmetic.equal",
          "ops.construct.expand_indptr_np", "ops.construct.expand_indptr",
          "ops.construct.compress_indptr",
          "ops.construct.complex_embed_block_size",
          "ops.graph.component_labels", "ops.graph.islands",
          "ops.slicing.sample_offsets", "ops.validate.has_sorted_indices",
          "ops.validate.has_canonical_format", "ops.validate.validate"),
    **_no(NO_FLOAT, "ops.construct.eye", "ops.construct.random_csc"),
    **_no(BUILD, "ops.spgemm.spgemm_symbolic", "ops.spgemm.gram_symbolic"),
    # parallel
    **_no(HOST_IO, "parallel.banded.DistBandedLU",
          "parallel.banded.DistBandedLU.blocks",
          "parallel.banded.DistBandedLU.solve",
          "parallel.banded.DistBandedLU.unblocks"),
    **_no(HOST, "parallel.banded.DistBandedLU.solve_host",
          "parallel.schur.SchurLU.solve_host"),
    **_no(BUILD, "parallel.banded.DistBandedLU.factor_device",
          "parallel.partition.partition_rows", "parallel.schur.SchurLU",
          "parallel.schur.SchurLU.device_plan",
          "parallel.solve.BlockJacobi.build",
          "parallel.solve.DiagJacobi.build"),
    **_no(WHILE, "parallel.solve.dist_cg", "parallel.solve.dist_bicgstab"),
    # types
    **_no(SPGEMM, "types.CSC.dot"),
    **_no(HOST, "types.CSC.from_dense", "types.CSC.from_scipy",
          "types.CSC.np_arrays", "types.CSC.to_bsr", "types.CSC.to_scipy",
          "types.CSR.from_scipy", "types.CSR.np_arrays", "types.CSR.t",
          "types.CSR.to_scipy", "types.COO.from_scipy", "types.COO.np_arrays",
          "types.COO.to_csc", "types.COO.to_csr", "types.COO.to_scipy",
          "types.BSR.from_scipy", "types.BSR.multiply", "types.BSR.t",
          "types.BSR.to_csc", "types.BSR.to_scipy", "types.BSR.todense",
          "types.DIA", "types.DIA.from_scipy", "types.DIA.np_arrays",
          "types.DIA.to_csc", "types.DIA.to_scipy", "types.DIA.todense"),
    **_no(INTEGER, "types.CSC.get_nnz", "types.CSC.islands",
          "utils.misc.slice_to_range"),
    # utils
    **_no(IO, "utils.io.save_npz", "utils.io.load_npz", "utils.io.save_lu",
          "utils.io.load_lu", "utils.io.save_banded", "utils.io.load_banded",
          "utils.misc.dense_to_str"),
    **_no(META, "utils.profiling.timeit", "utils.profiling.nnz_per_sec",
          "utils.profiling.Timer", "utils.profiling.Timer.section",
          "utils.profiling.Timer.summary", "utils.profiling.trace",
          "utils.profiling.compare_with_scipy",
          "utils.roofline.measure_hbm_bw", "utils.roofline.plan_bytes",
          "utils.roofline.pct_roofline", "utils.roofline.tflops",
          "utils.roofline.thomas_factor_flops"),
}

# -- jax.grad differentiates these; the port does not yet --------------------
GRAD_OPEN = {}

#: the attribute kinds that are not callables (properties, named-tuple
#: fields, class-level constants)
NOT_CALLABLE = ("property", "_tuplegetter", "tuple", "type")


def _surface():
    """Every public callable of the walked modules, as 'module.name' and
    'module.Class.method' (the package's own functions without a module
    prefix)."""
    names = set()
    for rel in _jax_modules():
        jm = importlib.import_module("csparse3_tpu" + (f".{rel}" if rel
                                                       else ""))
        skip = NOT_TO_PORT.get(rel, set()) | NOT_TO_PORT["*"]
        prefix = f"{rel}." if rel else ""
        for name, attrs in _defined(jm).items():
            if name in skip:
                continue
            names.add(prefix + name)
            for a in attrs or ():
                if a in skip or f"{name}.{a}" in skip:
                    continue
                kind = type(inspect.getattr_static(getattr(jm, name), a))
                if kind.__name__ not in NOT_CALLABLE:
                    names.add(f"{prefix}{name}.{a}")
    return names


def test_checklist_covers_the_surface():
    lists = (set(GRAD_HELD), set(NO_JAX_GRAD), set(GRAD_OPEN))
    for a, b in ((0, 1), (0, 2), (1, 2)):
        assert not lists[a] & lists[b], lists[a] & lists[b]
    filed = set().union(*lists)
    surface = _surface()
    assert not surface - filed, sorted(surface - filed)
    assert not filed - surface, sorted(filed - surface)


def _test_functions(path):
    tree = ast.parse((HERE / path).read_text())
    return {node.name for node in tree.body
            if isinstance(node, ast.FunctionDef)}


@pytest.mark.parametrize("path", sorted({p for p, _ in
                                         GRAD_HELD.values()}))
def test_every_held_gradient_names_its_test(path):
    tests = _test_functions(path)
    missing = sorted(t for p, t in GRAD_HELD.values()
                     if p == path and t not in tests)
    assert not missing, missing


def test_the_reference_entries_are_filed_as_the_jax_package_behaves():
    """Entries ``jax.grad`` refuses on the JAX package's side (host numpy
    or a while_loop) that callers might expect to differentiate: the
    sensitivities, the DC flow, the host-in-host-out solvers and the
    Krylov loops."""
    for name in ("models.sensitivity.ptdf", "models.sensitivity.lodf",
                 "models.powerflow.dc_power_flow",
                 "parallel.banded.DistBandedLU",
                 "linalg.spike_stream.StreamedSPIKE.solve",
                 "ops.spgemm_device.spgemm_device",
                 "ops.spgemm_device.gram_device",
                 "models.powerflow.NewtonPowerFlow.run",
                 "linalg.iterative.cg", "linalg.iterative.bicgstab",
                 "parallel.solve.dist_cg"):
        assert name in NO_JAX_GRAD, name
