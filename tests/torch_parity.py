"""Shared parts of the port's parity tests against the JAX package.

Each side builds the same problem through its own package, and its own
grammar compiles the same tree strings or builds the same hand-made cycle,
since the port's IR objects are not the reference's.  `cycle` builds the
textbook V-cycle with a chosen smoother on either side.
"""

from __future__ import annotations

import contextlib
import random
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evostencils_tpu.grammar import gp as jax_gp
from evostencils_tpu.grammar import multigrid as jax_multigrid
from evostencils_tpu.ir import base as jax_base
from evostencils_tpu.ir import partitioning as jax_part
from evostencils_tpu.ir import smoother as jax_smoother
from evostencils_torch.grammar import gp, multigrid
from evostencils_torch.ir import base, partitioning, smoother

INFINITY = 1e100
JAX_DTYPES = {
    torch.float32: jnp.float32, torch.float64: jnp.float64,
    torch.complex64: jnp.complex64, torch.complex128: jnp.complex128,
}


class Package(NamedTuple):
    gp: object
    grammar: object
    base: object
    smoother: object
    part: object


JAX = Package(jax_gp, jax_multigrid, jax_base, jax_smoother, jax_part)
PORT = Package(gp, multigrid, base, smoother, partitioning)


class Side:
    """One package's problem and primitive set."""

    def __init__(self, package: Package, problem, depth=None, maximum_local_system_size=8):
        self.package = package
        self.problem = problem
        self.pset, self.terminals = package.grammar.generate_primitive_set(
            problem.approximation(), problem.rhs(), problem.dimension,
            problem.coarsening_factors, problem.max_level, problem.equations,
            problem.operators, problem.fields,
            depth=problem.max_level - problem.min_level if depth is None else depth,
            maximum_local_system_size=maximum_local_system_size,
            FAS=bool(getattr(problem, "uses_fas", False)),
        )

    def compile(self, tree_string):
        g = self.package.gp
        return g.compile_tree(g.parse_tree(tree_string, self.pset), self.pset)[0]

    def smoother_factory(self, kind):
        sm = self.package.smoother
        if kind == "collective":
            return sm.generate_collective_jacobi
        if kind == "decoupled":
            return sm.generate_decoupled_jacobi
        if kind == "newton":
            return lambda A: sm.generate_jacobi_newton(A, 1)
        if kind == "picard":
            return sm.generate_jacobi_picard
        n_fields = len(self.problem.fields)
        return lambda A: sm.generate_collective_block_jacobi(A, (kind,) * n_fields)

    def cycle(self, pre, post, omega, kind="collective", red_black=True, levels=None,
              coarse_solver=None):
        """Textbook V(pre, post) over `levels` levels (all by default), the
        smoother `kind` ("collective", "decoupled", "newton", "picard" or a
        block shape), an exact coarsest solve, or the expression
        `coarse_solver(coarse operator)` (a Krylov method); FAS problems get
        the τ-corrected coarse problem and the solution-restriction
        correction."""
        b, part = self.package.base, self.package.part
        partitioning = part.RedBlack if red_black else part.Single
        factory = self.smoother_factory(kind)
        fas = bool(getattr(self.problem, "uses_fas", False))
        levels = len(self.terminals) if levels is None else levels

        if isinstance(kind, tuple):
            # The grammar smooths with block Jacobi on one partition only.
            partitioning = part.Single

        def smooth(u, f, A, steps):
            for _ in range(steps):
                corr = b.Multiplication(b.Inverse(factory(A)), b.Residual(A, u, f))
                u = b.Cycle(u, f, corr, partitioning=partitioning, relaxation_factor=omega)
            return u

        def v(index, u, f):
            t = self.terminals[index]
            A = t.operator
            u = smooth(u, f, A, pre)
            f_c = b.Multiplication(t.restriction, b.Residual(A, u, f))
            if fas:
                restricted_u = b.Multiplication(t.restriction, u)
                f_c = b.Addition(f_c, b.Multiplication(t.coarse_operator, restricted_u))
            if index + 1 < levels:
                coarse = v(index + 1, self.terminals[index + 1].approximation, f_c)
                if fas:
                    raise ValueError("FAS cycles are two-grid here")
            else:
                solver = b.CoarseGridSolver(
                    "CGS", t.coarse_operator,
                    None if coarse_solver is None else coarse_solver(t.coarse_operator))
                coarse = b.Multiplication(solver, f_c)
                if fas:
                    coarse = b.Subtraction(coarse, restricted_u)
            u = b.Cycle(u, f, b.Multiplication(t.prolongation, coarse), relaxation_factor=1.0)
            return smooth(u, f, A, post)

        return v(0, self.terminals[0].approximation, self.problem.rhs())


def seeded_trees(side: Side, seed: int, count: int, min_height=2, max_height=16):
    """`count` random grammar trees of the port's primitive set, as strings."""
    rng = random.Random(seed)
    return [str(gp.gen_grow(side.pset, min_height, max_height, rng=rng)) for _ in range(count)]


def jax_state(state, dtype):
    return tuple(jnp.asarray(np.asarray(x), dtype=dtype) for x in state)


def assert_close_relative(got, expected, tolerance):
    """Every field within `tolerance` of the largest magnitude of the
    expected state."""
    scale = max(float(np.abs(np.asarray(e)).max()) for e in expected)
    for g, e in zip(got, expected):
        g = g.detach().cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        np.testing.assert_allclose(g / scale, np.asarray(e) / scale, rtol=0, atol=tolerance)


class EagerCapture:
    """Stands in for a CUDA graph: replay() calls the body."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


def eager_capture(fn, warmup=1, pool=None):
    """Stands in for evostencils_torch.backend.graphs.capture on the CPU:
    the warm-ups run fn, as they do on the card (where the capture itself
    runs nothing), and the "graph" calls fn at every replay.  Counted as a
    capture."""
    from evostencils_torch.backend import graphs

    for _ in range(warmup):
        fn()
    graphs.counters.add("captures")
    return graphs.Graph(EagerCapture(fn)), None


@pytest.fixture
def eager_graphs(monkeypatch):
    """graphs.capture replaced by the eager stand-in for the test."""
    from evostencils_torch.backend import graphs

    monkeypatch.setattr(graphs, "capture", eager_capture)


_TENSOR_READS = ("item", "__bool__", "__float__", "__int__", "__index__", "tolist", "cpu",
                 "numpy")
_HOST_DATA = ("tensor", "as_tensor", "from_numpy")


@contextlib.contextmanager
def no_host_reads():
    """Every way a body could read a tensor to the host, or make one from
    host data, raises inside the block."""
    saved = [(torch.Tensor, n, getattr(torch.Tensor, n)) for n in _TENSOR_READS]
    saved += [(torch, n, getattr(torch, n)) for n in _HOST_DATA]

    def refuse(owner, name, original):
        def refused(*args, **kwargs):
            if owner is torch and args and torch.is_tensor(args[0]):
                return original(*args, **kwargs)  # a tensor's own data, on its device
            raise AssertionError(f"a host read or host data inside a body: {name}")
        return refused

    for owner, name, original in saved:
        setattr(owner, name, refuse(owner, name, original))
    try:
        yield
    finally:
        for owner, name, original in saved:
            setattr(owner, name, original)
