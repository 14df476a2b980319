"""Pytree vectors and stacked Krylov bases.

Counterpart of the reference's abstract vector layer
(reference: src/AbstractTypes/AbstractVectors.fypp).  The reference defines
an abstract class with deferred ``zero/rand/scal/axpby/dot/get_size``
(AbstractVectors.fypp:295-320) and *array-of-vector* basis utilities:
``innerprod`` (X^H y and X^H Y, :659-695), ``Gram`` (:645-657),
``linear_combination`` (y = X v, Y = X B, :571-643) and elemental
``axpby_basis``/``zero_basis``/``copy``/``rand_basis`` (:697-730).

Design inversion for XLA: a *vector* is any pytree of ``jnp`` arrays and a
*basis* is the same pytree with one extra **leading** axis of length k
(stacked, not an array of objects).  Every basis reduction then becomes a
single reshaped matmul or one fused reduction, and — when leaves carry a
``NamedSharding`` over a device mesh — a single fused all-reduce per
contraction (the reference instead leaves distribution entirely to user MPI
code, paper/paper.md:35,97,101).

Conventions
-----------
* ``dot(x, y) = x^H y`` — first argument conjugated, matching the reference
  (AbstractVectors.fypp:659-695).
* Unfilled Krylov-buffer slots are kept exactly zero so that masked-free
  projections against the full buffer are algebraically exact.
"""

from __future__ import annotations

import operator
from functools import partial, reduce

import jax
import jax.numpy as jnp
import numpy as np

from . import constants

__all__ = [
    "dot",
    "norm",
    "scal",
    "axpby",
    "add",
    "sub",
    "chsgn",
    "zero_like",
    "default_key",
    "rand_like",
    "get_size",
    "dtype_of",
    "innerprod",
    "gram",
    "innerprod_vpu",
    "linear_combination",
    "linear_combination_vpu",
    "set_columns_block",
    "axpby_basis",
    "scal_basis",
    "zero_basis_like",
    "zeros_basis",
    "rand_basis",
    "copy",
    "stack",
    "unstack",
    "get_column",
    "set_column",
    "basis_size",
    "verify_vector_axioms",
]


# -- internals ---------------------------------------------------------------

def _leaves(x):
    return jax.tree_util.tree_leaves(x)


def _tree_sum(terms):
    """Sum a list of arrays (one per leaf) into one scalar/array."""
    return reduce(operator.add, terms)


def _as_matrix(leaf):
    """Flatten a basis leaf (k, *S) to (k, prod(S))."""
    return leaf.reshape(leaf.shape[0], -1)


def _as_vector(leaf):
    return leaf.reshape(-1)


# -- vector algebra ----------------------------------------------------------

def dot(x, y):
    """Inner product ``x^H y`` summed over every leaf
    (reference: AbstractVectors.fypp:424-433 deferred ``dot``)."""
    terms = [
        jnp.vdot(xl, yl)  # vdot conjugates its first argument
        for xl, yl in zip(_leaves(x), _leaves(y))
    ]
    return _tree_sum(terms)


@jax.jit
def norm(x):
    """Euclidean norm (reference: AbstractVectors.fypp ``norm = sqrt(dot)``).

    Jitted: drivers call it eagerly on every vector kind, and one compiled
    executable per shape beats a chain of eager ops."""
    sq = _tree_sum([jnp.sum(jnp.real(xl * jnp.conj(xl))) for xl in _leaves(x)])
    return jnp.sqrt(sq)


def scal(alpha, x):
    """``alpha * x`` (reference: deferred ``scal``)."""
    return jax.tree.map(lambda xl: alpha * xl, x)


def axpby(alpha, x, beta, y):
    """``alpha*x + beta*y`` (reference: deferred ``axpby``)."""
    return jax.tree.map(lambda xl, yl: alpha * xl + beta * yl, x, y)


def add(x, y):
    return jax.tree.map(jnp.add, x, y)


def sub(x, y):
    return jax.tree.map(jnp.subtract, x, y)


def chsgn(x):
    return jax.tree.map(jnp.negative, x)


def zero_like(x):
    return jax.tree.map(jnp.zeros_like, x)


@partial(jax.jit, static_argnums=0)
def _prng_key_jit(seed: int):
    return jax.random.PRNGKey(seed)


def default_key(seed: int = 0):
    """``jax.random.PRNGKey(seed)``, built inside ``jit`` so the seed folds
    into the compiled executable and the key materializes on device.
    Solvers create keys lazily, only on the zero-seed path."""
    return _prng_key_jit(int(seed))


@partial(jax.jit, static_argnames=("ifnorm",))
def rand_like(key, x, ifnorm: bool = False):
    """Standard-normal random vector with the structure/dtype of ``x``
    (reference: deferred ``rand``; normalization flag as in ``rand(ifnorm)``).

    Jitted: one executable instead of an eager op per leaf."""
    leaves, treedef = jax.tree_util.tree_flatten(x)
    keys = jax.random.split(key, len(leaves))
    new_leaves = []
    for k, leaf in zip(keys, leaves):
        if np.issubdtype(leaf.dtype, np.complexfloating):
            rdt = constants.real_dtype_of(leaf.dtype)
            re = jax.random.normal(k, leaf.shape, rdt)
            im = jax.random.normal(jax.random.fold_in(k, 1), leaf.shape, rdt)
            new_leaves.append((re + 1j * im).astype(leaf.dtype))
        else:
            new_leaves.append(jax.random.normal(k, leaf.shape, leaf.dtype))
    out = jax.tree_util.tree_unflatten(treedef, new_leaves)
    if ifnorm:
        out = scal(1.0 / norm(out), out)
    return out


def get_size(x) -> int:
    """Total number of scalar entries (reference: deferred ``get_size``)."""
    return sum(int(np.prod(leaf.shape)) for leaf in _leaves(x))


def dtype_of(x):
    """Dtype of the (first leaf of the) vector."""
    return _leaves(x)[0].dtype


# -- basis (stacked leading axis) algebra ------------------------------------

def basis_size(X) -> int:
    """Number of columns k of a stacked basis."""
    return _leaves(X)[0].shape[0]


def stack(vectors):
    """Stack a list of vectors into a basis with leading axis k."""
    return jax.tree.map(lambda *ls: jnp.stack(ls, axis=0), *vectors)


def unstack(X):
    """Inverse of :func:`stack`."""
    k = basis_size(X)
    return [get_column(X, i) for i in range(k)]


def get_column(X, i):
    """Extract column ``i`` of a stacked basis as a vector."""
    return jax.tree.map(lambda l: l[i], X)


def set_column(X, i, v):
    """Functionally set column ``i`` of a stacked basis."""
    return jax.tree.map(lambda Xl, vl: Xl.at[i].set(vl), X, v)


def copy(X):
    """Defensive copy (functional arrays make this a no-op identity)."""
    return jax.tree.map(lambda l: l, X)


def zeros_basis(x_template, k: int):
    """A k-column zero basis shaped like ``x_template``
    (reference: ``zero_basis``, AbstractVectors.fypp:697-708).

    Propagates the template's ``NamedSharding`` with a replicated leading
    (column) axis, so Krylov buffers of row-partitioned state vectors are
    allocated sharded rather than replicated — essential at 10M-DoF scale.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    def leaf_fn(l):
        shape = (k,) + l.shape
        sharding = getattr(l, "sharding", None)
        if isinstance(sharding, NamedSharding):
            spec = PartitionSpec(None, *sharding.spec)
            return jnp.zeros(shape, l.dtype,
                             device=NamedSharding(sharding.mesh, spec))
        return jnp.zeros(shape, l.dtype)

    return jax.tree.map(leaf_fn, x_template)


def zero_basis_like(X):
    return jax.tree.map(jnp.zeros_like, X)


@partial(jax.jit, static_argnames=("k",))
def lead(X, k: int):
    """Leading ``k`` stacked columns of a basis buffer, sliced under jit."""
    return jax.tree.map(lambda l: l[:k], X)


@partial(jax.jit, static_argnames=("ifnorm",))
def rand_basis(key, X, ifnorm: bool = False):
    """Random basis with the structure of ``X`` (reference: ``rand_basis``)."""
    k = basis_size(X)
    cols = [rand_like(jax.random.fold_in(key, i), get_column(X, 0), ifnorm) for i in range(k)]
    return stack(cols)


def innerprod(X, y):
    """Batched inner products against a stacked basis.

    ``innerprod(X, y) -> (k,)`` with entries ``X_i^H y`` and
    ``innerprod(X, Y) -> (k, m)`` with entries ``X_i^H Y_j``
    (reference: AbstractVectors.fypp:659-695).  Each case is one reshaped
    matmul per leaf — on a sharded mesh XLA lowers the reduction to a single
    fused all-reduce, which is the "batched dot product" design target of
    SURVEY.md §2 item 3.
    """
    X_leaves, y_leaves = _leaves(X), _leaves(y)
    x0, y0 = X_leaves[0], y_leaves[0]
    # HIGHEST matmul precision: a default-precision f32 matmul may run in
    # TF32 on GPU tensor cores (about three decimal digits), which costs
    # ~3 digits of orthogonality per CGS pass — fatal for Krylov
    # reductions.  The reductions are bandwidth-bound, so full f32
    # arithmetic is far from the bottleneck.
    P = jax.lax.Precision.HIGHEST
    if y0.ndim == x0.ndim - 1:
        # basis x vector -> (k,)
        terms = [
            jnp.matmul(_as_matrix(Xl).conj(), _as_vector(yl), precision=P)
            for Xl, yl in zip(X_leaves, y_leaves)
        ]
    else:
        # basis x basis -> (k, m)
        terms = [
            jnp.einsum("ks,ms->km", _as_matrix(Xl).conj(), _as_matrix(yl),
                       precision=P)
            for Xl, yl in zip(X_leaves, y_leaves)
        ]
    return _tree_sum(terms)


def gram(X):
    """Gram matrix ``X^H X`` (reference: AbstractVectors.fypp:645-657)."""
    return innerprod(X, X)


def _chunk_of(X, lo, hi):
    return jax.tree.map(lambda l: l[lo:hi], X)


def innerprod_prefix(X, y, k, chunk: int = 8):
    """``innerprod(X, y)`` reading only the chunks that intersect the
    filled prefix ``[0, k)`` of the stacked buffer.

    Exactness relies on the buffer invariant (unfilled columns are exactly
    zero): a skipped chunk's contribution is zero, so the result equals
    ``innerprod(X, y)`` while chunks entirely beyond ``k`` are behind an
    HLO conditional whose untaken branch never touches HBM.  Inside a
    GMRES/Arnoldi sweep this cuts the dominant CGS2 streaming cost from
    ``O(kdim)`` to ``O(k)`` columns per iteration — the dynamic-shape-free
    answer to the reference's growing-basis projections
    (gram_schmidt.fypp:141-146 projects against ``X(:k)``).

    ``k`` may be a traced scalar.  On a sharded mesh each live chunk
    carries its own (small) all-reduce — set ``chunk=None`` in
    :mod:`gram_schmidt` to restore the single fused all-reduce per pass.
    """
    m = basis_size(X)
    if chunk is None or chunk >= m:
        return innerprod(X, y)
    k = jnp.asarray(k, jnp.int32)
    parts = []
    for lo in range(0, m, chunk):
        hi = min(m, lo + chunk)
        Xc = _chunk_of(X, lo, hi)
        shape = jax.eval_shape(innerprod, Xc, y)
        parts.append(jax.lax.cond(
            lo < k,
            lambda op: innerprod(*op),
            lambda op: jnp.zeros(shape.shape, shape.dtype),
            (Xc, y)))
    return jnp.concatenate(parts, axis=0)


def linear_combination_prefix(X, v, k, chunk: int = 8):
    """``linear_combination(X, v)`` reading only chunks intersecting the
    filled prefix ``[0, k)`` (see :func:`innerprod_prefix`; requires the
    matching coefficients beyond the live chunks to be zero, which holds
    for projections computed by :func:`innerprod_prefix`)."""
    m = basis_size(X)
    if chunk is None or chunk >= m:
        return linear_combination(X, v)
    k = jnp.asarray(k, jnp.int32)
    acc = None
    for lo in range(0, m, chunk):
        hi = min(m, lo + chunk)
        Xc = _chunk_of(X, lo, hi)
        vc = v[lo:hi]
        shapes = jax.eval_shape(linear_combination, Xc, vc)
        part = jax.lax.cond(
            lo < k,
            lambda op: linear_combination(*op),
            lambda op: jax.tree.map(
                lambda s: jnp.zeros(s.shape, s.dtype), shapes),
            (Xc, vc))
        acc = part if acc is None else add(acc, part)
    return acc


def linear_combination(X, v):
    """``X v`` for a coefficient vector (k,) or matrix (k, m).

    (k,)   -> a vector;    (k, m) -> a basis with leading axis m.
    (reference: AbstractVectors.fypp:571-643 — basis compression / Ritz
    vector reconstruction; a tall-skinny GEMM.)
    """
    v = jnp.asarray(v)
    v_cplx = np.issubdtype(v.dtype, np.complexfloating)

    def contract(coeff, mat):
        if coeff.ndim == 1:
            # Rank-k update as a broadcast-multiply + reduction: one
            # full-f32 streaming pass over the basis that XLA fuses into a
            # single loop (no TF32 rounding, no materialized product).
            return jnp.sum(coeff[:, None] * mat, axis=0)
        # matrix coefficients (basis compression / reconstruction): a real
        # GEMM at HIGHEST precision (see innerprod: TF32 costs ~3 digits).
        return jnp.einsum("km,ks->ms", coeff, mat,
                          precision=jax.lax.Precision.HIGHEST)

    def leaf_fn(Xl):
        mat = _as_matrix(Xl)
        leaf_cplx = np.issubdtype(Xl.dtype, np.complexfloating)
        if v_cplx and not leaf_cplx:
            # Complex coefficients on a real basis (Ritz-vector
            # reconstruction of a real operator): contract real and
            # imaginary parts as two *real* matmuls and recombine — half
            # the bytes of promoting the basis to complex.
            rdt = Xl.dtype
            re = contract(v.real.astype(rdt), mat)
            im = contract(v.imag.astype(rdt), mat)
            flat = jax.lax.complex(re, im)
        else:
            dt = jnp.result_type(v.dtype, Xl.dtype)
            flat = contract(v.astype(dt), mat.astype(dt))
        shape = Xl.shape[1:] if v.ndim == 1 else (v.shape[1],) + Xl.shape[1:]
        return flat.reshape(shape)

    return jax.tree.map(leaf_fn, X)


def linear_combination_vpu(X, C):
    """``X C`` for a SMALL number of output columns (C of shape (k, p) with
    p ~ 2): one broadcast-multiply + reduce pass over the basis.

    The general matrix path of :func:`linear_combination` lowers to a
    GEMM, which for very skinny outputs may run below memory bandwidth.
    CRITICAL: the broadcast must keep the leaf's ORIGINAL trailing shape —
    flattening to (k, s) before broadcasting lost the reduce fusion inside
    solver loops under XLA and materialized the (k, p, s) intermediate.
    Returns a stacked basis with leading axis ``p``.
    """
    C = jnp.asarray(C)

    def leaf_fn(Xl):
        dt = jnp.result_type(C.dtype, Xl.dtype)
        Cb = C.astype(dt)[(...,) + (None,) * (Xl.ndim - 1)]  # (k, p, 1...)
        out = jnp.sum(Cb * Xl.astype(dt)[:, None], axis=0)
        return out  # (p,) + leaf column shape

    return jax.tree.map(leaf_fn, X)


def innerprod_vpu(X, Y):
    """``X^H Y`` for a stacked RHS block with FEW columns (p ~ 2), as a
    broadcast-multiply + tree-reduce over the basis stream (full f32/f64
    accumulation — no matmul unit, so no TF32 concern).

    Same shape rule as :func:`linear_combination_vpu`: broadcasting on the
    leaf's original trailing shape is what lets XLA fuse the reduction
    into a single bandwidth-speed pass inside solver loops."""
    X_leaves, Y_leaves = _leaves(X), _leaves(Y)
    terms = []
    for Xl, Yl in zip(X_leaves, Y_leaves):
        axes = tuple(range(2, Xl.ndim + 1))
        terms.append(jnp.sum(Xl.conj()[:, None] * Yl[None], axis=axes))
    return _tree_sum(terms)


def set_columns_block(X, i, B):
    """Write the stacked block ``B`` (leading axis p) into columns
    ``i .. i+p-1`` of the buffer in ONE dynamic-update-slice per leaf
    (``i`` may be traced) — cheaper than p separate column writes and a
    single store dependency for the scheduler."""
    i = jnp.asarray(i)

    def leaf_fn(Xl, Bl):
        start = (i,) + (jnp.zeros((), i.dtype),) * (Xl.ndim - 1)
        return jax.lax.dynamic_update_slice(Xl, Bl.astype(Xl.dtype), start)

    return jax.tree.map(leaf_fn, X, B)


def axpby_basis(alpha, X, beta, Y):
    """Elementwise-column ``alpha*X + beta*Y``
    (reference: ``axpby_basis``, AbstractVectors.fypp:709-720)."""
    return jax.tree.map(lambda Xl, Yl: alpha * Xl + beta * Yl, X, Y)


def scal_basis(alpha, X):
    """Scale each column; ``alpha`` may be scalar or shape (k,)."""
    alpha = jnp.asarray(alpha)

    def leaf_fn(Xl):
        a = alpha.astype(Xl.dtype)
        if a.ndim == 1:
            a = a.reshape((-1,) + (1,) * (Xl.ndim - 1))
        return a * Xl

    return jax.tree.map(leaf_fn, X)


# -- property-based axiom checking -------------------------------------------

def verify_vector_axioms(key, x_template, n_trials: int = 100, rtol=None):
    """Check the 8 vector-space axioms on random data.

    Counterpart of ``verify_vector_axioms``
    (reference: AbstractVectors.fypp:733-927): commutativity and
    associativity of addition, additive identity and inverse, scalar
    distributivity (both ways), scalar-multiplication associativity and
    multiplicative identity.  Raises ``AssertionError`` on violation.
    """
    dt = dtype_of(x_template)
    tol = rtol if rtol is not None else constants.rtol(dt)

    def rand_scalar(k):
        if constants.is_complex_dtype(dt):
            r = jax.random.normal(k, (2,), constants.real_dtype_of(dt))
            return (r[0] + 1j * r[1]).astype(dt)
        return jax.random.normal(k, (), dt)

    for trial in range(n_trials):
        kt = jax.random.fold_in(key, trial)
        k1, k2, k3, k4, k5 = jax.random.split(kt, 5)
        x = rand_like(k1, x_template)
        y = rand_like(k2, x_template)
        z = rand_like(k3, x_template)
        a = rand_scalar(k4)
        b = rand_scalar(k5)
        scale = float(norm(x)) + 1.0

        def check(u, v, label):
            err = float(norm(sub(u, v))) / scale
            assert err < tol, f"vector axiom '{label}' violated: err={err:.3e}"

        check(add(x, y), add(y, x), "commutativity")
        check(add(add(x, y), z), add(x, add(y, z)), "associativity")
        check(add(x, zero_like(x)), x, "additive identity")
        check(add(x, chsgn(x)), zero_like(x), "additive inverse")
        check(scal(a, add(x, y)), add(scal(a, x), scal(a, y)), "distributivity over vectors")
        check(scal(a + b, x), add(scal(a, x), scal(b, x)), "distributivity over scalars")
        check(scal(a * b, x), scal(a, scal(b, x)), "scalar associativity")
        check(scal(jnp.asarray(1, dt), x), x, "multiplicative identity")
