"""Gaussian-mixture latent prior.

Counterpart of `cape_tpu.models.gmm`: the mixture as float32 numpy arrays,
a loader for the shipped 18-dim sklearn pickle (assets/pretrained_gmm.pkl)
and for priors written by `tools.fit_latent_gmm`, sampling, the log
density in torch, and the numpy EM fitter. `sample` draws through
`core.prng`, JAX's PRNG, so a key gives the JAX package's components and
latents; `sample_np` draws from a numpy Generator, as the servers do.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cape_tpu_torch.core import prng


@dataclasses.dataclass(frozen=True)
class GMM:
    weights: np.ndarray        # [M]
    means: np.ndarray          # [M, D]
    covariances: np.ndarray    # [M, D, D]
    chols: np.ndarray          # [M, D, D] cholesky factors

    @classmethod
    def create(cls, weights, means, covariances) -> "GMM":
        cov = np.asarray(covariances, dtype=np.float64)
        return cls(
            weights=np.asarray(weights, np.float32),
            means=np.asarray(means, np.float32),
            covariances=cov.astype(np.float32),
            chols=np.linalg.cholesky(cov).astype(np.float32),
        )

    @classmethod
    def load_pretrained(cls) -> "GMM":
        from cape_tpu_torch.meshops.assets import load_gmm

        d = load_gmm()
        return cls.create(d["weights"], d["means"], d["covariances"])

    @classmethod
    def from_npz(cls, path: str) -> "GMM":
        """Load a prior written by tools.fit_latent_gmm (the refit path for
        models whose nz is not the shipped prior's 18)."""
        d = np.load(path)
        return cls.create(d["weights"], d["means"], d["covariances"])

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def sample(self, key: np.ndarray, n: int) -> np.ndarray:
        """n latents from a `core.prng` key: the key splits in two, the
        components are a categorical draw over log(weights), the noise a
        normal draw, z = mu_k + chol_k @ eps (float32, as JAX's)."""
        k_comp, k_eps = prng.split(key)
        comps = prng.categorical(k_comp, np.log(self.weights), shape=(n,))
        eps = prng.normal(k_eps, (n, self.dim))
        z = self.means[comps].astype(np.float64) + np.einsum(
            "nij,nj->ni", self.chols[comps].astype(np.float64), eps.astype(np.float64)
        )
        return z.astype(np.float32)

    def sample_np(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """The same distribution from a numpy Generator (the servers' host
        draw; the JAX package's `sample_np` draw for draw)."""
        w = np.asarray(self.weights, np.float64)
        comps = rng.choice(len(w), size=n, p=w / w.sum())
        chol = np.asarray(self.chols, np.float64)[comps]
        eps = rng.standard_normal((n, chol.shape[-1]))
        mu = np.asarray(self.means, np.float64)[comps]
        return (mu + np.einsum("nij,nj->ni", chol, eps)).astype(np.float32)

    def log_prob(self, x) -> torch.Tensor:
        """Log density of x [N, D] under the mixture (float32 torch, on
        x's device when x is a tensor)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        means = torch.from_numpy(self.means).to(x.device)
        chols = torch.from_numpy(self.chols).to(x.device)
        diff = x[:, None, :] - means[None]                             # [N, M, D]
        sol = torch.linalg.solve_triangular(
            chols[None].expand(x.shape[0], *chols.shape), diff[..., None], upper=False
        )[..., 0]
        maha = (sol * sol).sum(-1)                                     # [N, M]
        logdet = 2.0 * torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
        log_comp = -0.5 * (maha + logdet + self.dim * math.log(2.0 * math.pi))
        log_w = torch.log(torch.from_numpy(self.weights).to(x.device))
        return torch.logsumexp(log_w[None] + log_comp, dim=-1)


def fit_gmm(
    x: np.ndarray,
    n_components: int = 10,
    n_iter: int = 100,
    seed: int = 0,
    reg_covar: float = 1e-6,
) -> GMM:
    """Full-covariance EM in numpy (the JAX package's fitter, step for step)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, dtype=np.float64)
    n, d = x.shape
    means = x[rng.choice(n, n_components, replace=False)]
    covs = np.tile(np.cov(x.T) + reg_covar * np.eye(d), (n_components, 1, 1))
    weights = np.full(n_components, 1.0 / n_components)

    for _ in range(n_iter):
        # E-step: responsibilities via stable log densities
        log_r = np.zeros((n, n_components))
        for k in range(n_components):
            chol = np.linalg.cholesky(covs[k])
            sol = np.linalg.solve(chol, (x - means[k]).T).T
            maha = np.sum(sol**2, axis=1)
            logdet = 2.0 * np.sum(np.log(np.diag(chol)))
            log_r[:, k] = np.log(weights[k]) - 0.5 * (maha + logdet + d * np.log(2 * np.pi))
        log_r -= log_r.max(axis=1, keepdims=True)
        r = np.exp(log_r)
        r /= r.sum(axis=1, keepdims=True)

        # M-step
        nk = r.sum(axis=0) + 1e-10
        weights = nk / n
        means = (r.T @ x) / nk[:, None]
        for k in range(n_components):
            diff = x - means[k]
            covs[k] = (r[:, k, None] * diff).T @ diff / nk[k] + reg_covar * np.eye(d)

    return GMM.create(weights, means, covs)
