"""The plain reference: the deck's physics in plain PyTorch, independent of
the port (it imports nothing of ``aztotmd_tpu_torch`` and takes nothing the
port made: it reads the deck's text itself and draws its own initial
velocities and photon table from the seed).

What it computes, in any floating dtype (float64 for the reference, a
lower one for the control):

- the start: the initial velocities and, under the radiative thermostat,
  its photon table, drawn from the seed in the port's documented order
  (``init_vel gaus``: Gaussian velocities, drift removed, scaled to the
  target kinetic energy; then photon energies Gamma(5, kT) capped at 1 eV);
- the step, in the engine's stage order: under Nose-Hoover a scaling pass
  from the previous step's kinetic energy, velocity Verlet with the
  periodic wrap, the pair forces and energies of every pair within the
  cutoff (Lennard-Jones, or Surkov with per-atom thermal radii), the
  equilibration rescale, then the thermostat: Nose-Hoover's second pass,
  or the radiative thermostat (counter-keyed noise, a pure function of
  (seed, step, atom id): murmur3 fmix32 words, 16-bit uniforms) and the
  thermal radii;
- the RDF sample: integer counts of every pair within ``r_rdf`` in bins of
  ``d_rdf``, weighted by 2V/N^2.

Pairs are found by a cell search over the periodic box (``PairList``),
rebuilt whenever an atom has moved half the list's skin, so that the list
holds every pair within reach at every step.  The formulas are frozen
copies of the engine's (``ops/vdw.py``, ``ops/integrate.py``,
``ops/thermostat.py``, ``ops/prng.py``, ``ops/rdf.py`` of the port and of
the JAX package it ports), written out here so that a change to the port
cannot change the yardstick.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# internal units: A, ps, eV, e; mass in eV ps^2 / A^2 (the engine's
# units.py, from the reference's const.h)
_E_SI = 1.60217733e-19
M_SCALE = 1.6605402e-27 / (_E_SI * 1e-24 / 1e-20)     # amu -> internal
KB = 1.3806488e-23 / _E_SI                             # eV / K
REV_LIGHT = 3.33567e-5                                 # 1/c, ps/A

MASK32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
GOLD = 0x9E3779B9
PHOTON_STRIDE = 2654435761


# ----------------------------------------------------------------------
# the deck's text

def _lines(text):
    return [ln.split() for ln in text.splitlines() if ln.split()]


def deck_params(control: str, field: str) -> dict:
    """The numbers of a one-species deck that the reference needs, read
    from its control and field text."""
    p = {"n_equil": 0, "freq_equil": 0, "init_vel": "zero"}
    for w in _lines(control):
        k = w[0]
        if k == "timestep":
            p["dt"] = float(w[1])
        elif k == "nequil":
            p["n_equil"] = int(w[1])
        elif k == "eqfreq":
            p["freq_equil"] = int(w[1])
        elif k == "temperature":
            p["temp"] = float(w[1])
            p["tstat"] = w[2]
            if w[2] == "nose":
                p["tau"] = float(w[3])
        elif k == "init_vel":
            p["init_vel"] = w[1]
        elif k == "rdf":
            p["r_rdf"], p["d_rdf"] = float(w[1]), float(w[2])
            p["fr_rdf"] = int(w[3])
        elif k == "stat":
            p["stat"] = int(w[1])
    fl = _lines(field)
    if fl[0][:2] != ["spec", "1"]:
        raise ValueError("the reference takes one-species decks")
    sp = fl[1]
    p["mass"] = float(sp[2]) * M_SCALE
    p["charge"] = float(sp[3])
    p["rad"] = (0.0, 1.0, 0.0)
    for i, w in enumerate(fl):
        if w[0] == "vdw":
            v = fl[i + 1]
            p["pot"] = v[2]
            p["r_cut"] = float(v[3])
            p["pot_p"] = [float(x) for x in v[4:]]
        elif w[0] == "radii":
            r = fl[i + 1]
            p["rad"] = (float(r[1]), float(r[2]), float(r[3]))
    if not (p["pot"] == "surk" and p["tstat"] == "radi"
            or p["pot"] == "lnjs" and p["tstat"] in ("radi", "nose")):
        raise ValueError("the reference takes LJ decks under the radiative "
                         "or the Nose-Hoover thermostat and Surkov decks "
                         "under the radiative one")
    if p["charge"] != 0.0:
        raise ValueError("the reference takes neutral decks (the declared "
                         "electrostatics are inert)")
    return p


# ----------------------------------------------------------------------
# the start

def initial(p: dict, n: int, seed: int):
    """(velocities (n, 3), photon energies (n,) or None under Nose-Hoover)
    in float64 NumPy, drawn from ``seed`` in the engine's order."""
    rng = np.random.default_rng(seed)
    if p["init_vel"] == "gaus":
        m = p["mass"]
        v = rng.normal(size=(n, 3)) / math.sqrt(m)
        v -= v.mean(axis=0, keepdims=True)
        kin = 0.5 * m * np.sum(v * v)
        deg_free = 3 * n - 1                     # the thermostat takes one
        te_kin = 0.5 * p["temp"] * KB * deg_free
        if kin > 0:
            v *= math.sqrt(te_kin / kin)
    elif p["init_vel"] == "zero":
        v = np.zeros((n, 3))
    else:
        raise ValueError(f"init_vel {p['init_vel']!r} is not in the "
                         "reference")
    if p["tstat"] != "radi":
        return v, None
    ph = np.minimum(rng.gamma(5.0, KB * p["temp"], size=n), 1.0)
    return v, ph


# ----------------------------------------------------------------------
# counter-keyed noise

def _mul32(x, c: int):
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def uniforms(seed_word: int, step: int, gid, dtype):
    """(n, 4) uniforms in [0, 1) with 16-bit resolution for (seed, step,
    atom id)."""
    seed = torch.full((), seed_word & MASK32, dtype=torch.int64,
                      device=gid.device)
    stp = torch.full((), step & MASK32, dtype=torch.int64, device=gid.device)
    s = _mix32(seed ^ _mul32(stp, GOLD))
    h = _mix32((_mul32(gid & MASK32, _C2) + s) & MASK32)
    w0 = _mix32(h ^ GOLD)
    w1 = _mix32((h + _C1) & MASK32)
    u = [(w0 & 0xFFFF), (w1 & 0xFFFF), (w0 >> 16), (w1 >> 16)]
    return torch.stack([x.to(dtype) for x in u], -1) * (1.0 / 65536.0)


# ----------------------------------------------------------------------
# pairs

def min_image(d, box):
    return d - box * torch.round(d / box)


def pairs_within(x, box: float, r: float):
    """(i, j) of every pair i < j closer than ``r`` (minimum image), by a
    search over cells no narrower than ``r``; ``x`` in float64."""
    ok = torch.isfinite(x).all(1)
    if not bool(ok.all()):
        # atoms a low-precision control has lost take no part
        idx = torch.nonzero(ok).reshape(-1)
        i, j = pairs_within(x[idx], box, r)
        return idx[i], idx[j]
    n = x.shape[0]
    dev = x.device
    n_c = int(box // r)
    if n_c < 3 or n <= 8192:
        # small or dense: every pair is a candidate
        i, j = torch.triu_indices(n, n, 1, device=dev)
    else:
        edge = box / n_c
        c = torch.floor(x / edge).long() % n_c
        key = (c[:, 0] * n_c + c[:, 1]) * n_c + c[:, 2]
        order = torch.argsort(key)
        skey = key[order]
        ii, jj = [], []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    nc = (c + torch.tensor([dx, dy, dz], device=dev)) % n_c
                    nk = (nc[:, 0] * n_c + nc[:, 1]) * n_c + nc[:, 2]
                    lo = torch.searchsorted(skey, nk)
                    hi = torch.searchsorted(skey, nk, right=True)
                    cnt = hi - lo
                    tot = int(cnt.sum())
                    if tot == 0:
                        continue
                    a = torch.repeat_interleave(
                        torch.arange(n, device=dev), cnt)
                    start = torch.repeat_interleave(lo, cnt)
                    off = torch.arange(tot, device=dev) - torch.repeat_interleave(
                        torch.cumsum(cnt, 0) - cnt, cnt)
                    b = order[start + off]
                    keep = a < b
                    ii.append(a[keep])
                    jj.append(b[keep])
        i = torch.cat(ii) if ii else torch.zeros(0, dtype=torch.long,
                                                 device=dev)
        j = torch.cat(jj) if jj else torch.zeros(0, dtype=torch.long,
                                                 device=dev)
    d = min_image(x[i] - x[j], box)
    keep = (d * d).sum(-1) < r * r
    return i[keep], j[keep]


class PairList:
    """Every pair within ``reach`` at any step: the pairs within reach +
    ``skin`` at the last build, rebuilt once an atom has moved skin/2."""

    def __init__(self, box: float, reach: float, skin: float):
        self.box, self.reach, self.skin = box, reach, skin
        self.x0 = None

    def get(self, x):
        xd = x.double()
        if self.x0 is not None:
            d = min_image(xd - self.x0, self.box)
            if float((d * d).sum(-1).max()) < (0.5 * self.skin) ** 2:
                return self.i, self.j
        self.i, self.j = pairs_within(xd, self.box, self.reach + self.skin)
        self.x0 = xd.clone()
        return self.i, self.j


# ----------------------------------------------------------------------
# the step

class Reference:
    """The deck's dynamics in float64 from a given state.

    ``p``: ``deck_params``; ``box``; ``photons``: the start's photon
    table (None under Nose-Hoover, where ``n`` gives the atoms); ``seed``:
    the run's seed (its low 32 bits key the noise).  Every stage takes the
    dtype it computes in (``dt``): float64 for the reference, a lower one
    for the control (``step(s, low=...)``)."""

    def __init__(self, p, box, photons, seed, device=None, n=None):
        self.p, self.box = p, float(box)
        self.dev = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.nose = p["tstat"] == "nose"
        self.photons = None
        if photons is not None:
            self.photons = torch.as_tensor(photons, dtype=torch.float64,
                                           device=self.dev)
            n = self.photons.shape[0]
        self.n = int(n)
        self.seed_word = int(seed) & MASK32
        self.gid = torch.arange(self.n, device=self.dev)
        self.surkov = p["pot"] == "surk"
        reach = max(p["r_cut"], p.get("r_rdf", 0.0))
        self.pairs = PairList(self.box, reach, 2.0)
        self.n_bin = int(min(p["r_rdf"], self.box) / p["d_rdf"])
        self.rdf_w = 2.0 * self.box ** 3 / (float(self.n) * float(self.n))
        self.deg_free = 3 * self.n - 1
        self.te_kin = 0.5 * p["temp"] * KB * self.deg_free
        if self.nose:
            self.rqmass = 0.5 / self.te_kin / p["tau"] / p["tau"]
            self.qmass_tau2 = 2.0 * self.te_kin

    def forces(self, x, rad, dt=torch.float64):
        """(forces (n, 3), pair energy, sum of |pair energies|) of every
        pair within the cutoff, computed in ``dt``."""
        p = self.p
        x = x.to(self.dev, torch.float64)
        rad = rad.to(self.dev, dt)
        i, j = self.pairs.get(x)
        # the pair arithmetic in ``dt`` from the minimum-image vectors
        d = min_image(x[i] - x[j], self.box).to(dt)
        r2 = (d * d).sum(-1)
        m = (r2 < p["r_cut"] ** 2) & (r2 > 0)
        i, j, d, r2 = i[m], j[m], d[m], r2[m]
        r2i = 1.0 / r2
        if self.surkov:
            c1, c2, ki, kj = p["pot_p"]
            ri = 1.0 / torch.sqrt(r2)
            r6i = r2i * r2i * r2i
            ra, rb = rad[i], rad[j]
            c2sum = c2 / (ki * ra + kj * rb)
            rprod = ra * rb
            c1ab2 = rprod * rprod * c1
            e = rprod * r6i * (c1ab2 * ri - c2sum)
            f = rprod * r6i * r2i * (7.0 * c1ab2 * ri - 6.0 * c2sum)
        else:
            eps, sig = p["pot_p"][:2]
            p0, p1, p2 = 4.0 * eps, sig * sig, 24.0 * eps
            sr2 = p1 * r2i
            sr6 = sr2 * sr2 * sr2
            e = p0 * sr6 * (sr6 - 1.0)
            f = p2 * r2i * sr6 * (2.0 * sr6 - 1.0)
        fd = f[:, None] * d
        F = torch.zeros((self.n, 3), dtype=dt, device=self.dev)
        F.index_add_(0, i, fd)
        F.index_add_(0, j, -fd)
        return F, e.sum(), e.abs().sum()

    def rdf_counts(self, x, dt=torch.float64):
        """(n_bin,) counts of the pairs within r_rdf, distances in ``dt``
        from the minimum-image vectors."""
        x = x.to(self.dev, torch.float64)
        i, j = self.pairs.get(x)
        d = min_image(x[i] - x[j], self.box).to(dt)
        r2 = (d * d).sum(-1)
        m = r2 < self.p["r_rdf"] ** 2
        r = torch.sqrt(r2[m])
        ib = torch.clamp((r / self.p["d_rdf"]).long(), max=self.n_bin - 1)
        return torch.bincount(ib, minlength=self.n_bin).double()

    def rdf_hist(self, x, dt=torch.float64):
        """One RDF sample of positions ``x``: (n_bin,) counts weighted
        2V/N^2."""
        return self.rdf_counts(x, dt) * self.rdf_w

    def _verlet1(self, x, v, f, dt):
        """Half kick, drift and periodic wrap: (v, x)."""
        x, v, f = (a.to(self.dev, dt) for a in (x, v, f))
        hdt = 0.5 * self.p["dt"] / self.p["mass"]
        box = self.box
        v = v + hdt * f
        x = x + v * self.p["dt"]
        x = x - torch.floor(x / box) * box
        x = torch.where(x >= box, torch.zeros_like(x), x)
        return v, x

    def _verlet2(self, v, f, step, dt):
        """Second half kick and the equilibration rescale: (v, kin)."""
        v, f = v.to(self.dev, dt), f.to(self.dev, dt)
        p = self.p
        v = v + (0.5 * p["dt"] / p["mass"]) * f
        kin = 0.5 * p["mass"] * (v * v).sum()
        if p["n_equil"] and p["freq_equil"] and step <= p["n_equil"] \
                and step % p["freq_equil"] == 0 and float(kin) > 0:
            # to the target under Nose-Hoover, a quarter of it under the
            # radiative thermostat
            c = 1.0 if self.nose else 0.25
            v = v * torch.sqrt(c * self.te_kin / kin)
            kin = torch.full_like(kin, self.te_kin)
        return v, kin

    def _nose(self, v, kin, chit, consint, dt):
        """One Nose-Hoover scaling pass from the kinetic energy ``kin``:
        (v, kin, chit, consint)."""
        v = v.to(self.dev, dt)
        kin, chit, consint = (torch.as_tensor(a, dtype=torch.float64,
                                              device=self.dev).to(dt)
                              for a in (kin, chit, consint))
        h = self.p["dt"]
        chit = chit + h * (kin - self.te_kin) * self.rqmass
        tscale = 1.0 - h * chit
        v = v * tscale
        kin = kin * tscale * tscale
        consint = consint + h * chit * self.qmass_tau2
        chit = chit + h * (kin - self.te_kin) * self.rqmass
        return v, kin, chit, consint

    def _radiative(self, v, e, step, dt):
        """Photon absorb and re-emit: (v, engs, radii)."""
        v, e = v.to(self.dev, dt), e.to(self.dev, dt)
        m = self.p["mass"]
        u = uniforms(self.seed_word, step, self.gid, dt)
        shift = _mul32(torch.full((), step & MASK32, dtype=torch.int64,
                                  device=self.dev), PHOTON_STRIDE) % self.n
        pe = self.photons.to(dt)[((self.gid & MASK32) + shift) % self.n]
        v02 = (v * v).sum(-1)
        z = 2.0 * u[:, 0] - 1.0
        rho = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = (2.0 * math.pi) * u[:, 1]
        uvec = torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), z],
                           -1)
        v = v + (pe * REV_LIGHT / m)[:, None] * uvec
        v12 = (v * v).sum(-1)
        e = e + pe + 0.5 * m * (v02 - v12)
        do_rad = e > 1e-4
        v02 = v12
        rv0 = torch.rsqrt(torch.clamp(v02, min=1e-30))
        ph = 0.9 * e
        ermc = ph * REV_LIGHT / m
        ermcv0 = ermc * rv0
        xi = u[:, 2]
        cos_phi = torch.where(ermcv0 >= 1.0, torch.full_like(xi, -1.0),
                              xi * 2.0 * (1.0 - torch.clamp(ermcv0, max=1.0))
                              - 1.0)
        theta = (2.0 * math.pi) * u[:, 3]
        rv = _angled(v, cos_phi, theta)
        vr = v + ermc[:, None] * rv
        v12 = (vr * vr).sum(-1)
        er = e - (ph + 0.5 * m * (v12 - v02))
        v = torch.where(do_rad[:, None], vr, v)
        e = torch.where(do_rad, er, e)
        ra, rb, mx = self.p["rad"]
        radii = ra / (rb - torch.minimum(e, torch.full_like(e, mx)))
        return v, e, radii

    def step(self, s: dict, low=None):
        """One step from state ``s`` ({"x", "v", "f", "engs", "radii",
        "step"}; under Nose-Hoover also "chit", "consint" and "energies"
        with the previous step's "kin") in float64: the next state with its
        "energies" and "radii_in" (the radii its pair pass read).  With
        ``low``, also (second return value) each stage computed in ``low``
        from the float64 inputs of that stage, as a state of the same
        keys."""
        f64 = torch.float64
        st = s["step"]
        v0 = s["v"]
        if self.nose:
            v0, _, chit, consint = self._nose(
                s["v"], s["energies"]["kin"], s["chit"], s["consint"], f64)
        v1, x = self._verlet1(s["x"], v0, s["f"], f64)
        F, epot, eabs = self.forces(x, s["radii"])
        v2, kin = self._verlet2(v1, F, st, f64)
        out = {"x": x, "f": F, "radii_in": s["radii"], "step": st + 1}
        if self.nose:
            v, kin_t, chit_t, cons_t = self._nose(v2, kin, chit, consint,
                                                  f64)
            out.update(v=v, engs=s["engs"], radii=s["radii"], chit=chit_t,
                       consint=cons_t, energies=_energies(
                           kin_t, epot, eabs, torch.zeros_like(kin_t)))
        else:
            v, e, radii = self._radiative(v2, s["engs"], st, f64)
            out.update(v=v, engs=e, radii=radii,
                       energies=_energies(kin, epot, eabs, e.sum()))
        if low is None:
            return out
        _, x_l = self._verlet1(s["x"], v0, s["f"], low)
        F_l, epot_l, eabs_l = self.forces(x, s["radii"], low)
        ctl = {"x": x_l, "x_f": x, "f": F_l}
        if self.nose:
            v_l, kin_l, chit_l, cons_l = self._nose(v2, kin, chit, consint,
                                                    low)
            ctl.update(v=v_l, chit=chit_l, consint=cons_l,
                       energies=_energies(kin_l, epot_l, eabs_l,
                                          torch.zeros_like(kin_l)))
        else:
            _, kin_l = self._verlet2(v1, F, st, low)
            v_l, e_l, radii_l = self._radiative(v2, s["engs"], st, low)
            ctl.update(v=v_l, engs=e_l, radii=radii_l,
                       energies=_energies(kin_l, epot_l, eabs_l, e_l.sum()))
        return out, ctl


def _energies(kin, epot, eabs, temp):
    return {"kin": kin, "vdw": epot, "vdw_abs": eabs, "temp": temp,
            "tot": epot + kin, "coul1": torch.zeros_like(kin),
            "coul2": torch.zeros_like(kin)}


def _angled(v, cos_phi, theta):
    """Unit vector at angle acos(cos_phi) from v, rotated by theta around
    it (the engine's branch-free orthonormal basis)."""
    v1 = v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-30)
    ax = torch.argmin(torch.abs(v1), dim=-1)
    e = (ax[:, None] == torch.arange(3, device=v.device)).to(v.dtype)
    v2 = _cross(v1, e)
    v2 = v2 * torch.rsqrt((v2 * v2).sum(-1, keepdim=True) + 1e-30)
    v3 = _cross(v1, v2)
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    ct, st = torch.cos(theta), torch.sin(theta)
    return (v1 * cos_phi[:, None]
            + sin_phi[:, None] * (ct[:, None] * v2 + st[:, None] * v3))


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)
