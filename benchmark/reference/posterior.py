"""Plain reference of the trajectory posterior's HMC.

The pose graph's robust chi2 (between factors log(M^-1 Ti^-1 Tj) and SE(3)
priors log(M^-1 Ti), whitened by the upper Cholesky factor of each
information, a factor past its Huber delta counting delta * |r|), its
Levenberg-Marquardt mode (the solver's rules: lambda from 1e-6, x10 / /10,
damping lam * max(diag H, 1), stop on a relative chi2 decrease under 1e-9),
the Laplace whitening y = L^T x with L = chol(H + 1e-6 I) at the last
linearization, and one Metropolis-adjusted leapfrog trajectory per chain
(unit mass). Plain torch in any float dtype, from the graph's numpy inputs;
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import lie


def _upper_sqrt(info):
    return np.linalg.cholesky(0.5 * (info + info.T)).T


class GraphDensity:
    def __init__(self, poses0, between, priors, dtype, device):
        like = dict(dtype=dtype, device=device)
        self.like = like
        self.poses0 = torch.as_tensor(np.asarray(poses0), **like)
        self.K = self.poses0.shape[0]
        self.bi = torch.tensor([f[0] for f in between], device=device)
        self.bj = torch.tensor([f[1] for f in between], device=device)
        self.bT = torch.as_tensor(np.stack([f[2] for f in between]), **like)
        self.bS = torch.as_tensor(np.stack([_upper_sqrt(f[3]) for f in between]), **like)
        self.bd = torch.as_tensor([float(f[4]) for f in between], **like)
        self.pi = torch.tensor([f[0] for f in priors], device=device)
        self.pT = torch.as_tensor(np.stack([f[1] for f in priors]), **like)
        self.pS = torch.as_tensor(np.stack([_upper_sqrt(f[2]) for f in priors]), **like)
        self.pd = torch.full((len(priors),), math.inf, **like)

    # -- residuals ---------------------------------------------------------
    def _between_r(self, Ti, Tj, Tm):
        return lie.se3_log(lie.inverse(Tm) @ (lie.inverse(Ti) @ Tj))

    def _prior_r(self, Ti, Tm):
        return lie.se3_log(lie.inverse(Tm) @ Ti)

    @staticmethod
    def _robust(r, S, delta):
        rw = (S @ r[..., None])[..., 0]
        c2 = (rw * rw).sum(-1)
        e = torch.sqrt(torch.clamp(c2, min=1e-30))
        # a finite stand-in where delta is inf keeps the unused branch's
        # gradient finite (inf * 0 would poison it)
        d = torch.where(torch.isinf(delta), torch.ones_like(delta), delta)
        return torch.where(e <= delta, c2, d * e), rw, c2

    def chi2(self, poses):
        """poses (..., K, 4, 4) -> (...)."""
        r = self._between_r(poses[..., self.bi, :, :], poses[..., self.bj, :, :], self.bT)
        c = self._robust(r, self.bS, self.bd)[0].sum(-1)
        r = self._prior_r(poses[..., self.pi, :, :], self.pT)
        return c + self._robust(r, self.pS, self.pd)[0].sum(-1)

    # -- the mode ----------------------------------------------------------
    def _normal_equations(self, poses):
        K = self.K
        D = 6 * K
        H = torch.zeros((D, D), **self.like)
        b = torch.zeros(D, **self.like)

        def local_b(d, Ti, Tj, Tm):
            return self._between_r(Ti @ lie.exp_split(d[:6]), Tj @ lie.exp_split(d[6:]), Tm)

        def local_p(d, Ti, Tm):
            return self._prior_r(Ti @ lie.exp_split(d), Tm)

        jac_b = torch.func.vmap(torch.func.jacrev(local_b))
        jac_p = torch.func.vmap(torch.func.jacrev(local_p))
        chi2 = torch.zeros((), **self.like)
        fams = (
            ([self.bi, self.bj], jac_b(torch.zeros((len(self.bi), 12), **self.like),
                                       poses[self.bi], poses[self.bj], self.bT),
             self._between_r(poses[self.bi], poses[self.bj], self.bT), self.bS, self.bd),
            ([self.pi], jac_p(torch.zeros((len(self.pi), 6), **self.like), poses[self.pi],
                              self.pT),
             self._prior_r(poses[self.pi], self.pT), self.pS, self.pd),
        )
        for idx, J, r, S, delta in fams:
            c, rw, c2 = self._robust(r, S, delta)
            e = torch.sqrt(torch.clamp(c2, min=1e-30))
            w = torch.where(e <= delta, torch.ones_like(e), delta / e)
            w = torch.where(torch.isinf(delta), torch.ones_like(w), w)
            chi2 = chi2 + c.sum()
            SJ = S @ J  # (F, 6, 6 * len(idx))
            cols = torch.stack([6 * v[:, None] + torch.arange(6, device=v.device) for v in idx],
                               1).reshape(len(r), -1)  # (F, 6 * len(idx))
            blocks = torch.einsum("fri,frj,f->fij", SJ, SJ, w)
            H.index_put_((cols[:, :, None].expand_as(blocks), cols[:, None, :].expand_as(blocks)),
                         blocks, accumulate=True)
            b.index_put_((cols,), torch.einsum("fri,fr,f->fi", SJ, rw, w), accumulate=True)
        return H, b, chi2

    def solve(self, max_iterations: int = 30, lam0: float = 1e-6, factor: float = 10.0,
              rel_tol: float = 1e-9):
        """(mode poses (K, 4, 4), H (6K, 6K) of the last linearization)."""
        poses = self.poses0
        lam = lam0
        H = None
        self.iterations = 0
        for _ in range(max_iterations):
            self.iterations += 1
            H, b, chi2 = self._normal_equations(poses)
            A = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
            L, info = torch.linalg.cholesky_ex(A)
            if int(info) != 0:
                lam *= factor
                continue
            delta = torch.cholesky_solve(-b[:, None], L)[:, 0]
            new = poses @ lie.exp_split(delta.reshape(self.K, 6))
            chi2_new = self.chi2(new)
            accept = bool(chi2_new < chi2)
            rel = float(abs(chi2 - chi2_new) / max(float(chi2), 1e-30))
            if accept:
                poses = new
                lam /= factor
                if rel < rel_tol:
                    break
            else:
                lam *= factor
        return poses, H


class WhitenedPosterior:
    """log p(y) = -0.5 chi2(mode . exp_split(L^-T y)) and one HMC transition."""

    def __init__(self, density: GraphDensity, mode, H, jitter: float = 1e-6):
        self.density = density
        self.mode = mode
        n = H.shape[0]
        self.L = torch.linalg.cholesky(H + jitter * torch.eye(n, dtype=H.dtype, device=H.device))

    def logprob(self, y):
        D = y.shape[-1]
        x = torch.linalg.solve_triangular(self.L.mT, y.reshape(-1, D).mT, upper=True).mT
        x = x.reshape(y.shape)
        poses = self.mode @ lie.exp_split(x.reshape(*x.shape[:-1], self.density.K, 6))
        return -0.5 * self.density.chi2(poses)

    def value_and_grad(self, y):
        with torch.enable_grad():
            y = y.detach().requires_grad_(True)
            lp = self.logprob(y)
            (g,) = torch.autograd.grad(lp.sum(), y)
        return lp.detach(), g

    def transition(self, y, eps, z, log_u, n_leapfrog: int):
        """From y (C, D) with step eps (C,), momentum z (C, D) and log
        uniform log_u (C,): (next y, accept probability (C,))."""
        lp0, g = self.value_and_grad(y)
        e = eps[:, None]
        q, p = y, z
        lp = lp0
        for _ in range(n_leapfrog):
            p = p + 0.5 * e * g
            q = q + e * p
            lp, g = self.value_and_grad(q)
            p = p + 0.5 * e * g
        h0 = -lp0 + 0.5 * (z * z).sum(-1)
        h1 = -lp + 0.5 * (p * p).sum(-1)
        dh = h0 - h1
        log_a = torch.where(torch.isfinite(dh), torch.clamp(dh, max=0.0),
                            torch.full_like(dh, -math.inf))
        acc = log_u < log_a
        return torch.where(acc[:, None], q, y), torch.exp(log_a)
