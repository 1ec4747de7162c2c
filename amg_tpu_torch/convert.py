"""Float64 arrays -> the port's device `Hierarchy`.

The structured builder hands its host result to `hierarchy_from_arrays`, and
a hierarchy built by the reference package crosses over the same way: the
caller extracts plain numpy arrays and dicts from it (nothing of the
reference's types reaches this module), so both packages can run on an
identical hierarchy. Per level:

    {"A": {"kind": "stencil", "weights": (m,), "offsets", "grid_shape"}
          | {"kind": "var" | "dia", "coeffs": (m, *grid_shape), "offsets",
             "grid_shape"},
     "sm": {"scale": (n,), "inv_wscale": (n,), "w": ()},
     "transfer": None | {"fine_shape", "coarse_shape"[, "fine_mask",
                         "coarse_mask"]}}

"var" is the plain VarStencilOperator (reach-1 box, the coarse levels of the
structured Laplacian hierarchy), "dia" the DiaKernelOperator of kernel K5.
With masks (1 on free dofs, 0 on Dirichlet identity rows), P and R are
MaskedTransfers: P = diag(fine_mask) P0 diag(coarse_mask) and R its
transpose.

A level of the classical (generic) hierarchy has "transfer": None, its
matrices as CSR arrays in the format they take on the device,

    {"kind": "ell", "indptr", "indices", "data", "shape"[, "k"]}
    | {"kind": "bsr", "indptr", "indices", "data", "shape", "bm", "bn"}

(ELL rows padded to k, by default the widest row), for "A" (level 0 may be
any of the operator kinds above) and for "P", "R" and the additive
transfers "P_s", "R_s", "P_id", "R_id" (each absent, None or a matrix), and
block smoothers' "sm" also holds "block_inv" and "block_inv_bwd" (nblocks,
bs, bs).

plus the dense `coarse_Ainv` of the coarsest level.

A halo operator of the row-sharded path crosses over onto a mesh
(`halo_from_arrays`, parallel.dist.RowMesh) from the reference's arrays of
all D shards, of which the mesh's process keeps its own:

    {"kind": "halo_ell", "cols", "vals" (D, n_loc, k), "send_idx" (D, m, S)
     or (D, D, S), "ghost_map" (D, G), "offsets", "perms", "shape"[,
     "wire_send", "payload_send"]}
    | {"kind": "halo_bsr", "block_cols" (D, nrb_loc, kb), "blocks"
       (D, nrb_loc, kb, bm, bn), "send_idx", "ghost_map", "offsets",
       "perms", "shape"}
    | {"kind": "halo_stencil", "base": a "stencil" / "var" operator dict}

The AMS preconditioner's state crosses over the same way
(`ams_from_arrays`): {"G", "Gt"[, "Pi", "Pit"]} matrix dicts as above,
"inv_wscale" (n_edges,), and "node"[, "pi"] as (levels, coarse_Ainv) of the
nodal hierarchies.
"""

from __future__ import annotations

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device
from amg_tpu_torch.setup.hierarchy import Hierarchy, Level
from amg_tpu_torch.setup.structured import (
    DiaKernelOperator,
    MaskedTransfer,
    StructuredProlong,
    StructuredRestrict,
    VarStencilOperator,
)
from amg_tpu_torch.smooth.smoothers import smoother_data_from_arrays
from amg_tpu_torch.sparse.bsr import bsr_from_csr
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.sparse.ell import ell_from_csr
from amg_tpu_torch.sparse.stencil import StencilOperator



def _tensor(a, dtype, device):
    return torch.from_numpy(np.array(a, dtype=np.float64)).to(device=device, dtype=dtype)


def matrix_from_arrays(m, dtype, device):
    """An ELLMatrix or BSRMatrix from its CSR arrays (None -> None)."""
    if m is None:
        return None
    csr = CSRMatrix(indptr=np.asarray(m["indptr"]), indices=np.asarray(m["indices"]),
                    data=np.asarray(m["data"], dtype=np.float64),
                    shape=tuple(int(s) for s in m["shape"]))
    if m["kind"] == "ell":
        return ell_from_csr(csr, k=m.get("k"), dtype=dtype, device=device)
    if m["kind"] == "bsr":
        return bsr_from_csr(csr, bm=int(m["bm"]), bn=int(m["bn"]), dtype=dtype, device=device)
    raise ValueError(f"unknown matrix kind {m['kind']!r}")


def operator_from_arrays(A: dict, dtype, device):
    if A["kind"] in ("ell", "bsr"):
        return matrix_from_arrays(A, dtype, device)
    offsets = tuple(tuple(int(d) for d in o) for o in A["offsets"])
    grid_shape = tuple(int(s) for s in A["grid_shape"])
    if A["kind"] == "stencil":
        return StencilOperator(
            weights=_tensor(A["weights"], dtype, device),
            offsets=offsets, grid_shape=grid_shape,
        )
    if A["kind"] in ("var", "dia"):
        vs = VarStencilOperator(
            coeffs=_tensor(A["coeffs"], dtype, device),
            offsets=offsets, grid_shape=grid_shape,
        )
        return vs if A["kind"] == "var" else DiaKernelOperator.from_var_stencil(vs)
    raise ValueError(f"unknown operator kind {A['kind']!r}")


def hierarchy_from_arrays(levels, coarse_Ainv, dtype=torch.float64, device=None) -> Hierarchy:
    """The port's Hierarchy on `device` (None: the CUDA device; raises
    without one) in `dtype`, from float64 host arrays."""
    device = resolve_device(device)
    out = []
    for lv in levels:
        P = matrix_from_arrays(lv.get("P"), dtype, device)
        R = matrix_from_arrays(lv.get("R"), dtype, device)
        if lv["transfer"] is not None:
            fs = tuple(int(s) for s in lv["transfer"]["fine_shape"])
            cs = tuple(int(s) for s in lv["transfer"]["coarse_shape"])
            P = StructuredProlong.build(fs, cs, dtype, device)
            R = StructuredRestrict.build(fs, cs, dtype, device)
            if "fine_mask" in lv["transfer"]:
                fm = _tensor(lv["transfer"]["fine_mask"], dtype, device)
                cm = _tensor(lv["transfer"]["coarse_mask"], dtype, device)
                P = MaskedTransfer(inner=P, in_mask=cm, out_mask=fm)
                R = MaskedTransfer(inner=R, in_mask=fm, out_mask=cm)
        out.append(
            Level(
                A=operator_from_arrays(lv["A"], dtype, device), P=P, R=R,
                sm=smoother_data_from_arrays(lv["sm"], dtype, device),
                **{name: matrix_from_arrays(lv.get(name), dtype, device)
                   for name in ("P_s", "R_s", "P_id", "R_id")},
            )
        )
    return Hierarchy(levels=tuple(out), coarse_Ainv=_tensor(coarse_Ainv, dtype, device))


def ams_from_arrays(arrays: dict, dtype=torch.float64, device=None):
    """The port's AMSData on `device` (None: the CUDA device; raises without
    one) in `dtype`, from float64 host arrays."""
    from amg_tpu_torch.solve.ams import AMSData

    device = resolve_device(device)
    pi = {}
    if arrays.get("pi") is not None:
        pi = dict(Pi=matrix_from_arrays(arrays["Pi"], dtype, device),
                  Pit=matrix_from_arrays(arrays["Pit"], dtype, device),
                  pi_hier=hierarchy_from_arrays(*arrays["pi"], dtype=dtype, device=device))
    return AMSData(
        G=matrix_from_arrays(arrays["G"], dtype, device),
        Gt=matrix_from_arrays(arrays["Gt"], dtype, device),
        inv_wscale=_tensor(arrays["inv_wscale"], dtype, device),
        node_hier=hierarchy_from_arrays(*arrays["node"], dtype=dtype, device=device),
        **pi,
    )


def halo_from_arrays(arrays: dict, mesh, dtype=torch.float64):
    """The port's HaloELL / HaloBSR / HaloStencilOperator on `mesh` in
    `dtype`, from the reference's float64 / index arrays of all D shards."""
    from amg_tpu_torch.parallel.halo import make_halo_stencil
    from amg_tpu_torch.parallel.spcomm import halo_bsr_of, halo_ell_of

    kind = arrays["kind"]
    if kind == "halo_stencil":
        return make_halo_stencil(operator_from_arrays(arrays["base"], dtype, mesh.device), mesh)
    mine = slice(mesh.first_shard, mesh.first_shard + mesh.local_devices)
    common = dict(send_idx=np.asarray(arrays["send_idx"], np.int32),
                  ghost_map=np.asarray(arrays["ghost_map"], np.int32),
                  offsets=tuple(int(o) for o in arrays["offsets"]),
                  perms=tuple(tuple((int(p), int(d)) for p, d in perm)
                              for perm in arrays["perms"]),
                  shape=tuple(int(n) for n in arrays["shape"]), mesh=mesh, dtype=dtype)
    if kind == "halo_ell":
        return halo_ell_of(np.asarray(arrays["cols"])[mine], np.asarray(arrays["vals"])[mine],
                           wire_send=tuple(arrays.get("wire_send", ())),
                           payload_send=tuple(arrays.get("payload_send", ())), **common)
    if kind == "halo_bsr":
        return halo_bsr_of(np.asarray(arrays["block_cols"])[mine],
                           np.asarray(arrays["blocks"])[mine], **common)
    raise ValueError(f"unknown halo operator kind {kind!r}")
