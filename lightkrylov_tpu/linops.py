"""Abstract linear operators as pytree-registered callables.

Counterpart of the reference's abstract operator layer
(reference: src/AbstractTypes/AbstractLinops.fypp).  The reference defines an
abstract ``abstract_linop`` with deferred ``matvec``/``rmatvec``
(AbstractLinops.fypp:58-87) plus an operator algebra: ``adjoint_linop``
(:89-100,573-599), ``scaled_linop`` (:153-176), ``axpby_linop``
(:182-197,498-566), identity (:137-147), symmetric/hermitian marker types
(:199-258), the ``abstract_exptA_linop`` carrying a horizon ``tau``
(:105-123) and a concrete GEMV-backed ``dense_linop`` (:264-271,607-660).

Design inversion for XLA: operators are small immutable Python objects
registered as **pytrees**, so a whole operator (including its parameter
arrays) can be closed over by ``jax.jit``/``lax.scan`` and sharded with the
rest of the computation.  Where the reference forces users to hand-write
``rmatvec``, we derive the adjoint automatically from ``matvec`` via
``jax.linear_transpose`` (``A^H y = conj(A^T conj(y))``) whenever the
operator is square.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import vectors

__all__ = [
    "LinearOperator",
    "Preconditioner",
    "MatvecOperator",
    "DenseOperator",
    "DiagonalOperator",
    "IdentityOperator",
    "ScaledOperator",
    "AdjointOperator",
    "AxpbyOperator",
    "ComposedOperator",
    "adjoint",
    "aslinop",
]


class LinearOperator:
    """Base class for linear operators acting on pytree vectors.

    Subclasses declare pytree ``_children`` (array-valued fields) and
    ``_static`` (hashable configuration) and implement :meth:`matvec`.
    ``rmatvec`` defaults to the autodiff transpose.

    (reference: AbstractLinops.fypp:27-87 — base type with deferred
    matvec/rmatvec; the counting/timing wrappers ``apply_matvec`` of the
    reference are provided by :mod:`lightkrylov_tpu.utils.timer`.)
    """

    _children: tuple = ()
    _static: tuple = ()

    #: True for operators guaranteed self-adjoint (reference:
    #: ``abstract_sym_linop`` / ``abstract_hermitian_linop``,
    #: AbstractLinops.fypp:199-258).
    is_hermitian: bool = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # Auto-register every concrete subclass as a pytree node.
        def flatten(op):
            children = tuple(getattr(op, n) for n in cls._children)
            aux = tuple(getattr(op, n) for n in cls._static)
            return children, aux

        def unflatten(aux, children):
            obj = object.__new__(cls)
            for n, v in zip(cls._children, children):
                object.__setattr__(obj, n, v)
            for n, v in zip(cls._static, aux):
                object.__setattr__(obj, n, v)
            return obj

        jax.tree_util.register_pytree_node(cls, flatten, unflatten)

    # -- core interface ------------------------------------------------------

    def matvec(self, x):
        """Apply ``y = A x`` (reference: deferred ``matvec``)."""
        raise NotImplementedError

    def rmatvec(self, y):
        """Apply ``x = A^H y`` (reference: deferred ``rmatvec``).

        Default: autodiff transpose of :meth:`matvec`, valid for square
        operators (domain structure == codomain structure).
        """
        if self.is_hermitian:
            return self.matvec(y)
        yc = jax.tree.map(jnp.conj, y)
        (xt,) = jax.linear_transpose(self.matvec, yc)(yc)
        return jax.tree.map(jnp.conj, xt)

    def __call__(self, x):
        return self.matvec(x)

    def matvec_basis(self, X):
        """Apply the operator to every column of a stacked basis at once.

        Default: ``jax.vmap`` over :meth:`matvec` — XLA batches the p
        matvecs into one kernel (for dense operators this becomes a single
        GEMM instead of p GEMVs).  Subclasses with a cheaper batched
        form may override.  Used by the block Krylov methods
        (reference: the per-column matvec loop of block Arnoldi,
        arnoldi.fypp:34-73, which the abstract Fortran design cannot batch).
        """
        return jax.vmap(self.matvec)(X)

    def rmatvec_basis(self, Y):
        """Batched adjoint application (see :meth:`matvec_basis`)."""
        return jax.vmap(self.rmatvec)(Y)

    # -- operator algebra (reference: AbstractLinops.fypp:89-197) ------------

    @property
    def H(self) -> "LinearOperator":
        """Adjoint operator (reference: ``adjoint``, :573-599)."""
        return adjoint(self)

    def __mul__(self, sigma):
        return ScaledOperator(sigma, self)

    __rmul__ = __mul__

    def __neg__(self):
        return ScaledOperator(-1.0, self)

    def __add__(self, other):
        return AxpbyOperator(1.0, self, 1.0, aslinop(other))

    def __sub__(self, other):
        return AxpbyOperator(1.0, self, -1.0, aslinop(other))

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return ComposedOperator(self, other)
        return self.matvec(other)


def adjoint(A: LinearOperator) -> LinearOperator:
    """Adjoint of ``A``; collapses double adjoints
    (reference: AbstractLinops.fypp:573-599)."""
    if isinstance(A, AdjointOperator):
        return A.A
    if A.is_hermitian:
        return A
    return AdjointOperator(A)


def aslinop(A) -> LinearOperator:
    """Coerce a 2D array or callable into a :class:`LinearOperator`.

    Wrappers created here are marked ``_aslinop_wrapped`` so the call
    counters key them by bare class name: solvers call ``aslinop`` on every
    solve, and a fresh wrapper per call would otherwise fragment the counts
    of a repeatedly-solved raw matrix across ``DenseOperator``,
    ``DenseOperator#1``, ... instead of aggregating them.
    """
    if isinstance(A, LinearOperator):
        return A
    op = MatvecOperator(A) if callable(A) else DenseOperator(jnp.asarray(A))
    op._aslinop_wrapped = True
    return op


# -- concrete operators ------------------------------------------------------


class Preconditioner(LinearOperator):
    """Base class for iteration-aware preconditioners.

    Mirrors ``abstract_precond_*%apply(vec, [iter, current_residual,
    target_residual])`` (reference: IterativeSolvers.fypp:80-95): solvers
    call :meth:`apply` with the inner-iteration index and residual state so
    adaptive preconditioners (e.g. relaxed inner tolerances) are possible;
    FGMRES additionally permits per-iteration *varying* preconditioners.
    Plain :class:`LinearOperator` preconditioners are applied via ``matvec``.
    """

    def apply(self, v, iteration=0, current_residual=0.0, target_residual=0.0):
        return self.matvec(v)

    def matvec(self, x):
        return self.apply(x)


class MatvecOperator(LinearOperator):
    """Wrap user callables ``matvec(x)`` / ``rmatvec(y)`` into an operator.

    This is the matrix-free entry point replacing user subclasses of
    ``abstract_linop`` (reference: AbstractLinops.fypp:58-87).  Parameter
    arrays referenced by the callables should be passed via ``params`` so
    they travel through jit as pytree children: the callables then receive
    ``(params, x)``.
    """

    _children = ("params",)
    _static = ("_matvec", "_rmatvec", "is_hermitian")

    def __init__(self, matvec, rmatvec=None, params=None, is_hermitian=False):
        self._matvec = matvec
        self._rmatvec = rmatvec
        self.params = params
        self.is_hermitian = is_hermitian

    def matvec(self, x):
        if self.params is not None:
            return self._matvec(self.params, x)
        return self._matvec(x)

    def rmatvec(self, y):
        if self._rmatvec is None:
            return super().rmatvec(y)
        if self.params is not None:
            return self._rmatvec(self.params, y)
        return self._rmatvec(y)


class DenseOperator(LinearOperator):
    """Dense matrix operator on rank-1 array vectors
    (reference: ``dense_linop``, AbstractLinops.fypp:264-271,607-660)."""

    _children = ("data",)
    _static = ("is_hermitian",)

    def __init__(self, data, is_hermitian=False):
        self.data = jnp.asarray(data)
        self.is_hermitian = is_hermitian

    # HIGHEST: a default-precision f32 product may round to TF32 on a GPU,
    # far below the accuracy the solvers and their anchors assume.
    def matvec(self, x):
        return jnp.matmul(self.data, x, precision=jax.lax.Precision.HIGHEST)

    def rmatvec(self, y):
        return jnp.matmul(self.data.conj().T, y,
                          precision=jax.lax.Precision.HIGHEST)


class DiagonalOperator(LinearOperator):
    """Diagonal operator ``y = d * x`` elementwise over the pytree."""

    _children = ("d",)
    _static = ()

    def __init__(self, d):
        self.d = d

    def matvec(self, x):
        return jax.tree.map(lambda dl, xl: dl * xl, self.d, x)

    def rmatvec(self, y):
        return jax.tree.map(lambda dl, yl: jnp.conj(dl) * yl, self.d, y)


class IdentityOperator(LinearOperator):
    """Identity (reference: ``Id_*``, AbstractLinops.fypp:137-147)."""

    is_hermitian = True

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y


class ScaledOperator(LinearOperator):
    """``sigma * A`` (reference: ``scaled_linop``, AbstractLinops.fypp:153-176)."""

    _children = ("sigma", "A")
    _static = ()

    def __init__(self, sigma, A):
        self.sigma = jnp.asarray(sigma)
        self.A = aslinop(A)

    def matvec(self, x):
        return vectors.scal(self.sigma, self.A.matvec(x))

    def rmatvec(self, y):
        return vectors.scal(jnp.conj(self.sigma), self.A.rmatvec(y))


class AdjointOperator(LinearOperator):
    """``A^H``: swaps matvec and rmatvec
    (reference: ``adjoint_linop``, AbstractLinops.fypp:89-100)."""

    _children = ("A",)
    _static = ()

    def __init__(self, A):
        self.A = aslinop(A)

    def matvec(self, x):
        return self.A.rmatvec(x)

    def rmatvec(self, y):
        return self.A.matvec(y)


class AxpbyOperator(LinearOperator):
    """``alpha*op(A) + beta*op(B)`` with optional per-term adjoints
    (reference: ``axpby_linop``, AbstractLinops.fypp:182-197,498-566)."""

    _children = ("alpha", "A", "beta", "B")
    _static = ("transA", "transB")

    def __init__(self, alpha, A, beta, B, transA=False, transB=False):
        self.alpha = jnp.asarray(alpha)
        self.beta = jnp.asarray(beta)
        self.A = aslinop(A)
        self.B = aslinop(B)
        self.transA = transA
        self.transB = transB

    def matvec(self, x):
        ax = self.A.rmatvec(x) if self.transA else self.A.matvec(x)
        bx = self.B.rmatvec(x) if self.transB else self.B.matvec(x)
        return vectors.axpby(self.alpha, ax, self.beta, bx)

    def rmatvec(self, y):
        ay = self.A.matvec(y) if self.transA else self.A.rmatvec(y)
        by = self.B.matvec(y) if self.transB else self.B.rmatvec(y)
        return vectors.axpby(jnp.conj(self.alpha), ay, jnp.conj(self.beta), by)


class ComposedOperator(LinearOperator):
    """``(A @ B) x = A(B(x))`` — natural in the functional setting (the
    reference lacks composition; provided for API convenience)."""

    _children = ("A", "B")
    _static = ()

    def __init__(self, A, B):
        self.A = aslinop(A)
        self.B = aslinop(B)

    def matvec(self, x):
        return self.A.matvec(self.B.matvec(x))

    def rmatvec(self, y):
        return self.B.rmatvec(self.A.rmatvec(y))
