"""Toeplitz / circulant fast paths.

Rebuild of the reference's Toeplitz layer: the FFT circulant-embedding
MVM the reference gets from ToeplitzMatrices.jl+FFTW (used at
src/gramian.jl:172-189) becomes `jnp.fft` (XLA FFT), and the classic
O(n^2) direct solvers of src/toeplitz.jl (durbin:12-27, trench:31-71,
levinson:76-111) become masked fixed-buffer `lax.fori_loop` recurrences
(documented O(n) sequential scan depth with O(n) vector work per step —
SURVEY.md §7 stage 4a). For large n the scalable solve is CG on the FFT
MVM with a Strang circulant preconditioner (an alternative the
reference lacks).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .linop import LinearOperator
from .solvers import cg


def _default_float():
    """jnp.result_type(float) without the dtype-lattice walk (that call is
    ~40% of a lazy Toeplitz construction — the Kronecker-construction
    bench row is host-dispatch bound)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


# --------------------------------------------------------------------------
# FFT MVMs
# --------------------------------------------------------------------------


@jax.jit
def circulant_matvec(c, v):
    """C v where C_ij = c[(i - j) mod n]."""
    fc = jnp.fft.fft(c)
    fv = jnp.fft.fft(v, axis=0)
    if v.ndim > 1:
        fc = fc[:, None]
    out = jnp.fft.ifft(fc * fv, axis=0)
    return jnp.real(out).astype(v.dtype) if not jnp.iscomplexobj(v) else out


@jax.jit
def toeplitz_matvec(col, row, v):
    """T v via circulant embedding of size 2n: T_ij = col[i-j] (i>=j),
    row[j-i] (j>i)."""
    n = col.shape[0]
    z = jnp.zeros((1,), dtype=col.dtype)
    c = jnp.concatenate([col, z, jnp.flip(row[1:])])
    vp = jnp.pad(v, [(0, n)] + [(0, 0)] * (v.ndim - 1))
    return circulant_matvec(c, vp)[:n]


def _toeplitz_dense(col, row):
    n = col.shape[0]
    d = jnp.arange(n)[:, None] - jnp.arange(n)[None, :]
    return jnp.where(d >= 0, col[jnp.abs(d)], row[jnp.abs(d)])


def _circulant_dense(c):
    n = c.shape[0]
    d = jnp.arange(n)[:, None] - jnp.arange(n)[None, :]
    return c[jnp.mod(d, n)]


class CirculantOperator(LinearOperator):
    """Lazy circulant matrix (reference `Circulant` path, src/gramian.jl:186-189):
    O(n) storage, FFT MVM, exact spectral solve."""

    def __init__(self, c, *, num=None, dtype=None):
        """`c` may be the first column, or a zero-arg callable returning
        it (with `num` giving the size): construction is then O(1) with
        no device dispatch, matching the reference's lazy semantics
        (src/gramian.jl:186-189 builds the symbol eagerly but the
        Kronecker path src/algebra.jl:91-95 constructs lazily)."""
        if callable(c):
            if num is None:
                raise ValueError(
                    "CirculantOperator with a callable symbol needs `num` "
                    "(the size) — shape metadata must exist before the "
                    "first column evaluation")
            self._c_src = c
            n = num
            self.dtype = _default_float() if dtype is None else jnp.dtype(dtype)
        else:
            self._c_src = jnp.asarray(c)
            n = self._c_src.shape[0]
            self.dtype = self._c_src.dtype
        self.shape = (n, n)

    @property
    def c(self):
        if callable(self._c_src):
            # evaluate OUTSIDE any live trace: first use may be inside a
            # jit (e.g. closure_convert of a consumer's matvec), and
            # caching a tracer here leaks it out of its trace. Cast to
            # the declared dtype so op.dtype seen before first evaluation
            # stays truthful (ADVICE r4 low).
            with jax.ensure_compile_time_eval():
                self._c_src = jnp.asarray(self._c_src()).astype(self.dtype)
        return self._c_src

    @property
    def is_symmetric(self):
        # circulant from an even symbol (c[k] == c[n-k]) is symmetric
        return bool(jnp.allclose(self.c[1:], jnp.flip(self.c[1:])))

    @property
    def is_psd(self):
        return bool(jnp.all(jnp.real(jnp.fft.fft(self.c)) > 0))

    def _matvec(self, v):
        return circulant_matvec(self.c, v)

    _matmat = _matvec

    def eigenvalues(self):
        return jnp.fft.fft(self.c)

    def solve(self, b, **kw):
        fb = jnp.fft.fft(b, axis=0)
        fc = jnp.fft.fft(self.c)
        if jnp.ndim(b) > 1:
            fc = fc[:, None]
        x = jnp.fft.ifft(fb / fc, axis=0)
        return jnp.real(x).astype(b.dtype) if not jnp.iscomplexobj(b) else x

    def logdet(self):
        return jnp.sum(jnp.log(jnp.abs(jnp.fft.fft(self.c))))

    def todense(self):
        return _circulant_dense(self.c)

    def _dense_recipe(self):
        return _circulant_dense, (self.c,)

    def diagonal(self):
        return jnp.full((self.shape[0],), self.c[0])


class ToeplitzOperator(LinearOperator):
    """Lazy (possibly non-symmetric) Toeplitz matrix: O(n) storage, FFT MVM
    (reference SymmetricToeplitz/Toeplitz gramians, src/gramian.jl:167-183)."""

    def __init__(self, col, row=None, *, num=None, dtype=None):
        """`col`/`row` may be zero-arg callables (with `num` giving the
        size): construction is then O(1) host work, no device dispatch —
        the column evaluates on first use (lazy, like the reference's
        Kronecker-factor gramians, src/algebra.jl:91-95)."""
        if callable(col) or callable(row):
            if num is None:
                raise ValueError(
                    "ToeplitzOperator with a callable col/row needs `num` "
                    "(the size) — shape metadata must exist before the "
                    "first column evaluation")
        if callable(col):
            self._col_src = col
            n = num
            self.dtype = _default_float() if dtype is None else jnp.dtype(dtype)
        else:
            self._col_src = jnp.asarray(col)
            n = self._col_src.shape[0]
            self.dtype = self._col_src.dtype
        self._row_src = (row if row is None or callable(row)
                         else jnp.asarray(row))
        if (not callable(col) and row is not None and not callable(row)
                and self._col_src.shape[0] != self._row_src.shape[0]):
            raise ValueError("only square Toeplitz supported")
        self.shape = (n, n)
        self._sym = row is None

    @property
    def col(self):
        if callable(self._col_src):
            # evaluate OUTSIDE any live trace (see CirculantOperator.c);
            # cast to the declared dtype so pre-evaluation op.dtype stays
            # truthful (ADVICE r4 low)
            with jax.ensure_compile_time_eval():
                self._col_src = jnp.asarray(self._col_src()).astype(self.dtype)
            if self._col_src.shape[0] != self.shape[0]:
                raise ValueError(
                    f"lazy column evaluated to length "
                    f"{self._col_src.shape[0]}, declared num={self.shape[0]}")
        return self._col_src

    @property
    def row(self):
        if self._row_src is None:
            return self.col
        if callable(self._row_src):
            with jax.ensure_compile_time_eval():
                self._row_src = jnp.asarray(self._row_src()).astype(self.dtype)
            if self._row_src.shape[0] != self.shape[0]:
                raise ValueError(
                    f"lazy row evaluated to length "
                    f"{self._row_src.shape[0]}, declared num={self.shape[0]}")
        return self._row_src

    @property
    def is_symmetric(self):
        return self._sym

    @property
    def is_psd(self):
        # symmetry alone does NOT imply PSD (a Cosine-kernel Toeplitz is
        # indefinite). Sufficient check: if the 2n-2 circulant embedding's
        # symbol is nonnegative, the Toeplitz (a principal submatrix) is
        # PSD. A false negative only routes solve() to MINRES, which is
        # correct for any symmetric system.
        if not self._sym:
            return False
        c = jnp.concatenate([self.col, jnp.flip(self.col[1:-1])])
        lam = jnp.real(jnp.fft.fft(c))
        tol = 1e-10 * jnp.max(jnp.abs(lam))
        if bool(jnp.all(lam >= -tol)):
            return True
        # embedding-indefinite does not decide the Toeplitz itself; for
        # modest n settle it exactly (one-time Python-level cost at solve
        # planning), else stay conservative (MINRES handles PSD fine too)
        n = self.shape[0]
        if n <= 2048:
            ev = jnp.linalg.eigvalsh(self.todense())
            return bool(ev[0] >= -1e-10 * jnp.maximum(jnp.abs(ev[-1]), 1.0))
        return False

    def _matvec(self, v):
        return toeplitz_matvec(self.col, self.row, v)

    _matmat = _matvec

    def _rmatvec(self, v):
        return toeplitz_matvec(self.row, self.col, v)

    def todense(self):
        return _toeplitz_dense(self.col, self.row)

    def _dense_recipe(self):
        return _toeplitz_dense, (self.col, self.row)

    def diagonal(self):
        return jnp.full((self.shape[0],), self.col[0])

    def strang_preconditioner(self):
        """Strang circulant preconditioner solve-closure for PCG."""
        n = self.shape[0]
        k = jnp.arange(n)
        c = jnp.where(k <= n // 2, self.col[k], self.col[(n - k) % n])
        fc = jnp.real(jnp.fft.fft(c))
        # relative eigenvalue floor: near-singular circulant modes would
        # amplify roundoff and destabilize PCG (esp. in float32)
        floor = 1e-4 * jnp.max(jnp.abs(fc))
        fc = jnp.where(fc < floor, floor, fc)

        def Minv(v):
            return jnp.real(jnp.fft.ifft(jnp.fft.fft(v) / fc)).astype(v.dtype)

        return Minv

    def solve(self, b, method: str = "auto", tol=None, maxiter=None, **kw):
        """Direct O(n^2) Levinson below ~8k, else preconditioned CG on the
        FFT MVM (reference uses levinson, src/toeplitz.jl:100-111).
        Non-symmetric Toeplitz falls back to CGNR on the FFT MVM — the
        reference solves ANY lazy factorization iteratively
        (src/lazy_linear_algebra.jl:135-144)."""
        if not self._sym:
            from .solvers import solve as _solve

            return _solve(self, b, tol=tol, maxiter=maxiter, method="cgnr")
        b = jnp.asarray(b)
        n = self.shape[0]
        if method == "auto":
            method = "levinson" if n <= 8192 else "cg"
        from .solvers import cached_jit

        if method == "levinson":
            if b.ndim > 1:
                return jax.vmap(lambda bi: levinson(self.col, bi), 1, 1)(b)
            return levinson(self.col, b)
        Minv = self.strang_preconditioner()
        mv = self._matvec
        f = cached_jit(
            self,
            ("pcg", tol, maxiter),
            lambda: (lambda bb: cg(mv, bb, tol=tol, maxiter=maxiter, M=Minv)[0]),
        )
        if b.ndim > 1:
            return jax.vmap(f, 1, 1)(b)
        return f(b)


# --------------------------------------------------------------------------
# Direct O(n^2) recurrences (durbin / levinson / trench)
# --------------------------------------------------------------------------


def _rev_k(y, k):
    """Array z with z[i] = y[(k - 1 - i) mod n] — the masked 'reverse of
    the first k entries' primitive (reference reverse_dot/reverse_increment,
    src/toeplitz.jl:114-145)."""
    return jnp.roll(jnp.flip(y), k)


@jax.jit
def durbin(r):
    """Solve T y = -r where T = SymToeplitz([1, r[:n-1]]) (Yule-Walker),
    reference src/toeplitz.jl:12-27."""
    r = jnp.asarray(r)
    n = r.shape[0]
    idx = jnp.arange(n)

    y0 = jnp.zeros_like(r).at[0].set(-r[0])
    state = (y0, -r[0], jnp.ones((), r.dtype))

    def body(k, st):
        y, alpha, beta = st
        beta = beta * (1 - alpha**2)
        mask = idx < k
        yrev = jnp.where(mask, _rev_k(y, k), 0)
        alpha = -(r[k] + jnp.dot(jnp.where(mask, r, 0), yrev)) / beta
        y = jnp.where(mask, y + alpha * yrev, y)
        y = y.at[k].set(alpha)
        return (y, alpha, beta)

    y, _, _ = lax.fori_loop(1, n, body, state)
    return y


@jax.jit
def _levinson_normalized(r, b):
    """Solve K x = b, K = SymToeplitz([1, r]) (diag normalized to 1),
    reference src/toeplitz.jl:76-96."""
    n = b.shape[0]
    m = r.shape[0]  # = n - 1
    idx_m = jnp.arange(m)

    y0 = jnp.zeros_like(r).at[0].set(-r[0])
    x0 = jnp.zeros_like(b).at[0].set(b[0])
    state = (x0, y0, -r[0], jnp.ones((), b.dtype))

    def body(k, st):
        x, y, alpha, beta = st
        beta = beta * (1 - alpha**2)
        mask = idx_m < k
        r_k = jnp.where(mask, r, 0)
        xrev = jnp.where(mask, _rev_k(x[:m], k), 0)
        yrev = jnp.where(mask, _rev_k(y, k), 0)
        mu = (b[k] - jnp.dot(r_k, xrev)) / beta
        x = x.at[:m].set(jnp.where(mask, x[:m] + mu * yrev, x[:m]))
        x = x.at[k].set(mu)
        alpha_new = -(r[jnp.minimum(k, m - 1)] + jnp.dot(r_k, yrev)) / beta
        do_y = k < n - 1
        y_upd = jnp.where(mask, y + alpha_new * yrev, y)
        y_upd = y_upd.at[jnp.minimum(k, m - 1)].set(
            jnp.where(k < m, alpha_new, y_upd[jnp.minimum(k, m - 1)])
        )
        y = jnp.where(do_y, y_upd, y)
        alpha = jnp.where(do_y, alpha_new, alpha)
        return (x, y, alpha, beta)

    x, _, _, _ = lax.fori_loop(1, n, body, state)
    return x


def levinson(col, b):
    """Solve SymToeplitz(col) x = b; normalizes the diagonal like the
    reference (src/toeplitz.jl:100-111)."""
    col = jnp.asarray(col)
    b = jnp.asarray(b)
    r0 = col[0]
    r = col[1:] / r0
    return _levinson_normalized(r, b) / r0


@jax.jit
def _trench_normalized(r):
    """Inverse of K = SymToeplitz([1, r]) (Trench's algorithm,
    reference src/toeplitz.jl:56-71). The reference's sequential fill
    B[i,j] = B[i-1,j-1] + w_ij is a prefix-sum along diagonals — computed
    here as a vectorized skewed cumsum."""
    n = r.shape[0] + 1
    y = durbin(r)
    gamma = 1.0 / (1.0 + jnp.dot(r, y))
    nu = gamma * jnp.flip(y)  # nu[i] = gamma * y[n-2-i], length n-1

    # first row
    row0 = jnp.concatenate([gamma[None], gamma * y])

    # w[i, j] for i,j in 1..n-1: (nu[n-1-j] nu[n-1-i] - nu[i-1] nu[j-1]) / gamma
    i1 = jnp.arange(1, n)
    u = nu[n - 1 - i1]  # u[t] = nu[n-1-(t+1)]
    v = nu[i1 - 1]
    W = (jnp.outer(u, u) - jnp.outer(v, v)) / gamma  # (n-1, n-1), index [i-1, j-1]

    # B[i, j] (j >= i >= 1) = row0[j - i] + sum_{t=1..i} W[t, j - i + t]
    # skew W so diagonals become columns: S[t-1, d] = W[t-1, (d + t) - 1]
    def skew_row(wrow, t):
        # wrow index j-1; want entry at j = d + t  -> index d + t - 1
        return jnp.roll(wrow, -(t - 1))

    S = jax.vmap(skew_row)(W, i1)  # S[t-1, d] = W[t, d + t] for valid d
    C = jnp.cumsum(S, axis=0)  # C[i-1, d] = sum_{t<=i} W[t, d+t]

    # assemble upper triangle: B[i, j] = row0[j-i] + C[i-1, j-i] for 1<=i<=j
    ii = jnp.arange(n)[:, None]
    jj = jnp.arange(n)[None, :]
    d = jj - ii
    valid = (ii >= 1) & (d >= 0) & (d <= n - 1 - ii)
    Cpad = jnp.pad(C, ((1, 0), (0, 1)))  # row for i=0, col guard
    vals = row0[jnp.clip(d, 0, n - 1)] + jnp.where(
        valid, Cpad[jnp.clip(ii, 0, n - 1), jnp.clip(d, 0, n - 1)], 0.0
    )
    B = jnp.where(d >= 0, vals, 0.0)
    B = jnp.where(ii == 0, row0[jnp.clip(d, 0, n - 1)] * (d >= 0), B)
    # symmetrize
    return B + jnp.triu(B, 1).T


def trench(col):
    """Inverse of SymToeplitz(col) (src/toeplitz.jl:31-54)."""
    col = jnp.asarray(col)
    r0 = col[0]
    return _trench_normalized(col[1:] / r0) / r0
