"""Fresnel physics: DoLP -> zenith-angle inversion and normal priors.

A torch copy of the parts of polardepth_tpu/ops/fresnel.py that the serving
path uses.  The reference inverts the Fresnel rho(theta) curves with 1000-point
numpy grids and ``scipy.interpolate.interp1d(fill_value="extrapolate")``
(reference manydepth/normals_vec.py:11-60).  Here the curves are built the same
way in float64 numpy, pruned to 1e-5 rad, and grouped into the two-level table
of ``HierarchicalInterp``; the lookup runs on tensors.  The CUDA kernel
(csrc/polar_preprocess.cu) reads the same table and takes the same steps, so
this lookup is the kernel's plain version.

Out-of-range queries extrapolate linearly from the first or last segment, as
interp1d with fill_value="extrapolate" does: bin 0's coarse knot is -1e6, and
the padded fine thresholds are +1e6 with zero deltas.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_N_SAMPLES = 1000  # reference: np.linspace(0, np.pi/2, 1000)
_HALF_PI = float(np.pi / 2)


@functools.lru_cache(maxsize=8)
def _diffuse_curve(n: float):
    """rho_d(theta) of the diffuse-reflection branch, float64
    (polardepth_tpu/ops/fresnel.py:35-46)."""
    theta = np.linspace(0.0, np.pi / 2, _N_SAMPLES)
    s2 = np.sin(theta) ** 2
    rho = ((n - 1.0 / n) ** 2 * s2) / (
        2.0 + 2.0 * n ** 2
        - (n + 1.0 / n) ** 2 * s2
        + 4.0 * np.cos(theta) * np.sqrt(n ** 2 - s2)
    )
    return rho, theta


@functools.lru_cache(maxsize=8)
def _specular_curves(n: float):
    """The two monotone branches of the specular rho_s(theta) curve, split at
    its maximum; the decreasing branch is flipped so both ascend in rho
    (polardepth_tpu/ops/fresnel.py:49-62)."""
    theta = np.linspace(0.0, np.pi / 2, _N_SAMPLES)
    s = np.sin(theta)
    rho = (2.0 * s ** 2 * np.cos(theta) * np.sqrt(n ** 2 - s ** 2)) / (
        n ** 2 - s ** 2 - n ** 2 * s ** 2 + 2.0 * s ** 4
    )
    imax = int(np.argmax(rho))
    branch1 = (rho[:imax], theta[:imax])
    branch2 = (rho[imax:][::-1].copy(), theta[imax:][::-1].copy())
    return branch1, branch2


def prune_knots(xp: np.ndarray, fp: np.ndarray, tol: float):
    """Drop knots whose removal changes the piecewise-linear interpolant by
    less than ``tol`` anywhere (greedy Douglas-Peucker; a copy of
    polardepth_tpu/ops/fresnel.py:355-387).  The boundary segments survive
    verbatim: they define the extrapolation slopes."""
    xp = np.asarray(xp, np.float64)
    fp = np.asarray(fp, np.float64)
    keep = np.zeros(len(xp), bool)
    keep[0] = keep[-1] = True
    if len(xp) > 3:
        keep[1] = keep[-2] = True

    def recurse(i, j):
        if j <= i + 1:
            return
        interp = fp[i] + (xp[i + 1:j] - xp[i]) * ((fp[j] - fp[i]) /
                                                  (xp[j] - xp[i]))
        err = np.abs(interp - fp[i + 1:j])
        k = int(np.argmax(err))
        if err[k] > tol:
            keep[i + 1 + k] = True
            recurse(i, i + 1 + k)
            recurse(i + 1 + k, j)

    recurse(0, len(xp) - 1)
    idx = np.nonzero(keep)[0]
    return xp[idx], fp[idx]


class HierarchicalInterp:
    """The two-level rho -> theta table of the three curves (diffuse,
    specular branch 1, specular branch 2), built in float64 as
    polardepth_tpu/ops/fresnel.py:242-294 builds it.

    Segments are grouped 8 to a coarse bin.  A query finds its bin (the last
    one whose coarse knot is <= rho, within its curve's section), then adds
    to the bin's base segment parameters (x0, f0, slope) the deltas of the
    <= 7 fine thresholds it passes.

    ``_table`` rows (NB, 93), per curve section of 31 columns:
    [fine_thresh(7), d_x0(7), d_f0(7), d_slope(7), base_x0, base_f0,
    base_slope].
    """

    GROUP = 8

    def __init__(self, n: float = 1.5, prune_tol: float | None = 1e-5):
        self.n = float(n)
        b1, b2 = _specular_curves(self.n)
        curves = [_diffuse_curve(self.n), b1, b2]
        if prune_tol is not None:
            curves = [prune_knots(xp, fp, prune_tol) for xp, fp in curves]
        G = self.GROUP
        BIG = 1.0e6
        cknots = []
        rows = []
        sect_sizes = []
        for xp, fp in curves:
            xp = np.asarray(xp, np.float64)
            fp = np.asarray(fp, np.float64)
            sl = np.diff(fp) / np.diff(xp)
            seg = np.stack([xp[:-1], fp[:-1], sl], axis=-1)   # (S, 3)
            S = seg.shape[0]
            nb = -(-S // G)
            ck = np.empty(nb)
            ck[0] = -BIG                        # left extrapolation bin
            ck[1:] = xp[G::G][:nb - 1]
            tab = np.zeros((nb, 31))
            for b in range(nb):
                s0 = b * G
                grp = seg[s0:s0 + G]
                th = xp[s0 + 1:s0 + G][:grp.shape[0] - 1]
                d = np.diff(grp, axis=0)
                tab[b, 0:7] = BIG
                tab[b, 0:len(th)] = th
                tab[b, 7:7 + len(d)] = d[:, 0]
                tab[b, 14:14 + len(d)] = d[:, 1]
                tab[b, 21:21 + len(d)] = d[:, 2]
                tab[b, 28:31] = grp[0]
            cknots.append(ck)
            rows.append(tab)
            sect_sizes.append(nb)
        self.sect_sizes = sect_sizes
        NB = int(sum(sect_sizes))
        self._cknots = np.concatenate(cknots)                 # (NB,)
        self._table = np.zeros((NB, 93))
        off = 0
        for ci, (tab, nb) in enumerate(zip(rows, sect_sizes)):
            self._table[off:off + nb, 31 * ci:31 * ci + 31] = tab
            off += nb

    def device_tables(self):
        """float32 tables in the layout the kernel stages in shared memory:
        coarse knots (NB,), one 32-float row per bin (its curve's 31 columns
        and one pad), and the section offsets (4,) int32."""
        offsets = np.cumsum([0] + self.sect_sizes).astype(np.int32)
        rows = np.zeros((len(self._cknots), 32), np.float32)
        for ci in range(3):
            lo, hi = offsets[ci], offsets[ci + 1]
            rows[lo:hi, :31] = self._table[lo:hi, 31 * ci:31 * ci + 31]
        return self._cknots.astype(np.float32), rows, offsets


@functools.lru_cache(maxsize=8)
def host_tables(n: float, prune_tol: float | None):
    return HierarchicalInterp(n, prune_tol).device_tables()


@functools.lru_cache(maxsize=16)
def tables_on(device: torch.device, n: float, prune_tol: float | None):
    """The kernel's tables as tensors on ``device`` (built once per device)."""
    ck, rows, offsets = host_tables(n, prune_tol)
    return (torch.from_numpy(ck).to(device), torch.from_numpy(rows).to(device),
            offsets.tolist())


def theta_from_rho(rho: torch.Tensor, n: float = 1.5,
                   prune_tol: float | None = 1e-5):
    """rho (...,) float32 -> (theta_d, theta_s1, theta_s2), each rho.shape.

    The fine deltas are added one at a time, in threshold order, as the
    kernel adds them, so both round alike.
    """
    ck, rows, offsets = tables_on(rho.device, float(n), prune_tol)
    thetas = []
    for ci in range(3):
        lo, hi = offsets[ci], offsets[ci + 1]
        b = torch.searchsorted(ck[lo:hi], rho.contiguous(), right=True) - 1
        r = rows[b.clamp_(min=0) + lo]                     # (..., 32)
        x0, f0, sl = r[..., 28], r[..., 29], r[..., 30]
        zero = torch.zeros_like(rho)
        for k in range(7):
            ge = rho >= r[..., k]
            x0 = x0 + torch.where(ge, r[..., 7 + k], zero)
            f0 = f0 + torch.where(ge, r[..., 14 + k], zero)
            sl = sl + torch.where(ge, r[..., 21 + k], zero)
        thetas.append(f0 + (rho - x0) * sl)
    return tuple(thetas)


def spherical_normals(phi: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(azimuth, zenith) -> unit normal on a new trailing axis."""
    st = torch.sin(theta)
    return torch.stack([torch.cos(phi) * st, torch.sin(phi) * st,
                        torch.cos(theta)], dim=-1)


def normal_priors_from_xolp(xolp: torch.Tensor, n: float = 1.5,
                            prune_tol: float | None = 1e-5) -> torch.Tensor:
    """The 9-channel physics prior: (..., 2) XOLP -> (..., 9) normals.

    Channel blocks as in ShallowNormalsEncoder.get_normals (reference
    pre_encoders.py:99-113): N_diffuse(phi), N_spec1(phi + pi/2),
    N_spec2(phi + pi/2); the specular azimuth is turned by 90 degrees.
    """
    rho = xolp[..., 0]
    phi = xolp[..., 1]
    t_d, t_s1, t_s2 = theta_from_rho(rho, n, prune_tol)
    phi_spec = phi + _HALF_PI
    return torch.cat([spherical_normals(phi, t_d),
                      spherical_normals(phi_spec, t_s1),
                      spherical_normals(phi_spec, t_s2)], dim=-1)
