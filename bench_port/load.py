"""The general load generator: what a traffic file's parameters make.

Every traffic mix is a closed loop of one client that solves one
right-hand side after another with the operator set up once (a
time-stepping user). Solve i of a run with seed s gets

  b_i = u / ||u||_2,  u uniform on [0, 1) (the reference's `-rhs rand`),

drawn on the device by a torch.Generator seeded with mix(s, i, "rhs"), and
the async solvers draw their randomness from the port's generators seeded
with mix(s, i, "draws"). x0 = 0. The check's probe vector is drawn the
same way. So a seed fixes every input of a run, and two seeds share none.
"""

from __future__ import annotations

import hashlib

import torch

RHS_KINDS = ("uniform",)


def mix(seed: int, index: int, stream: str) -> int:
    """A 63-bit seed from (run seed, solve index, stream); any integer seed."""
    h = hashlib.blake2b(f"{int(seed)}:{int(index)}:{stream}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def check(traffic: dict) -> None:
    """Refuse a traffic file this generator cannot make."""
    if traffic.get("client") != "closed_loop" or traffic.get("clients") != 1:
        raise ValueError("the load generator makes a closed loop of one client")
    if traffic.get("rhs") not in RHS_KINDS or traffic.get("x0") != "zero":
        raise ValueError(f"rhs must be one of {RHS_KINDS} and x0 'zero'")
    if not 0.0 < float(traffic["tol"]) < 1.0:
        raise ValueError("tol must lie in (0, 1)")


def rhs(n: int, seed: int, index: int, device, dtype=torch.float64) -> torch.Tensor:
    """b of solve `index`: made on `device` in float64, normalised, then cast
    to the solve's dtype."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(mix(seed, index, "rhs"))
    u = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    return (u / torch.linalg.vector_norm(u)).to(dtype)


def probe(n: int, seed: int, device, dtype=torch.float64) -> torch.Tensor:
    """A vector of length n, uniform on [0, 1), drawn on `device` from the
    run's seed: what the check applies the level-0 operator to and the
    rooflines time the operators on."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(mix(seed, n, "probe"))
    return torch.rand(n, generator=g, dtype=torch.float64, device=device).to(dtype)
