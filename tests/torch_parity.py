"""Shared helpers of the tests/test_torch_*.py parity tests: carry a hierarchy
built by the JAX package across to the PyTorch port as plain numpy arrays
(the format of amg_tpu_torch.convert), and run Pallas kernels in interpret
mode."""

import numpy as np


def interp(fn, *args, **kw):
    """Run a Pallas entry point in interpret mode on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args, **kw)


def export_jax_hierarchy(hier, dia=False):
    """(levels, coarse_Ainv) of a JAX structured Hierarchy, as float64 numpy
    arrays and dicts for amg_tpu_torch.convert.hierarchy_from_arrays. With
    dia=True (a hierarchy of build_dia_structured_hierarchy, whose CPU levels
    are VarStencilOperators) the levels become the port's DIA operators, and
    masked transfers carry their masks."""
    from amg_tpu.setup.structured import (
        MaskedTransfer,
        StructuredRestrict,
        VarStencilOperator,
    )
    from amg_tpu.sparse.stencil import StencilOperator

    def f64(a):
        return np.asarray(a, dtype=np.float64)

    levels = []
    for lv in hier.levels:
        A = lv.A
        if isinstance(A, StencilOperator):
            Ad = {"kind": "stencil", "weights": f64(A.weights)}
        elif isinstance(A, VarStencilOperator):
            Ad = {"kind": "dia" if dia else "var", "coeffs": f64(A.coeffs)}
        else:
            raise TypeError(type(A).__name__)
        Ad.update(offsets=A.offsets, grid_shape=A.grid_shape)
        transfer = None
        if isinstance(lv.R, MaskedTransfer):
            assert isinstance(lv.R.inner, StructuredRestrict)
            transfer = {"fine_shape": lv.R.inner.fine_shape,
                        "coarse_shape": lv.R.inner.coarse_shape,
                        "fine_mask": f64(lv.R.in_mask), "coarse_mask": f64(lv.R.out_mask)}
        elif lv.R is not None:
            assert isinstance(lv.R, StructuredRestrict)
            transfer = {"fine_shape": lv.R.fine_shape, "coarse_shape": lv.R.coarse_shape}
        levels.append({
            "A": Ad,
            "sm": {"scale": f64(lv.sm.scale), "inv_wscale": f64(lv.sm.inv_wscale),
                   "w": f64(lv.sm.w)},
            "transfer": transfer,
        })
    return levels, f64(hier.coarse_Ainv)


def port_hierarchy(jax_hier, dtype=None, dia=False):
    """The port's CPU Hierarchy carried across from a JAX hierarchy."""
    import torch

    from amg_tpu_torch.convert import hierarchy_from_arrays

    levels, ainv = export_jax_hierarchy(jax_hier, dia=dia)
    return hierarchy_from_arrays(
        levels, ainv, dtype=dtype or torch.float64, device="cpu"
    )
