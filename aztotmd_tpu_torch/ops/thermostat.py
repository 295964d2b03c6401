"""Thermostats (port of ``aztotmd_tpu/ops/thermostat.py``): the
equilibration rescale, Nose-Hoover, and the radiative (photon-exchange)
thermostat with the thermal radii that feed the Surkov potential.

The radiative thermostat has a hand-written CUDA kernel,
``csrc/tstat.cu``, built and loaded by ``ops/cuda_build.py``:
``tstat_radiative`` sends CUDA tensors to it and CPU tensors to
``tstat_radiative_plain`` (the torch ops it repeats, operation for
operation, with the same counter-keyed words), and raises on any other
device.  The rescale and Nose-Hoover are torch ops on both devices.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import units
from ..io.control import TSTAT_NOSE, TSTAT_RADI

from . import cuda_build, prng

REV_LIGHT = 3.33567e-5      # 1/c, ps/A
_PHOTON_STRIDE = 2654435761  # odd 32-bit stride of the photon rotation

# launches of csrc/tstat.cu made by tstat_radiative; a plain int that
# tools checking the main path reset and read
launches = 0


def sample_photon_energies(n: int, temp: float, rng: np.random.Generator):
    """Photon energies: Gamma(5, kT) capped at 1 eV (host, NumPy)."""
    kt = units.KB * temp
    return np.minimum(rng.gamma(5.0, kt, size=n), 1.0)


def temp_scale(cfg, vel, eng_kin):
    """Velocity rescale to the target kinetic energy (0.25 of it under
    the radiative thermostat)."""
    c = 0.25 if cfg.tstat_type == TSTAT_RADI else 1.0
    k = torch.sqrt(torch.full_like(eng_kin, c * cfg.te_kin) / eng_kin)
    k = torch.where(eng_kin > 0.0, k, torch.ones_like(k))
    return vel * k, torch.full_like(eng_kin, cfg.te_kin)


def nose_apply(cfg, vel, eng_kin, chit, consint):
    """One Nose-Hoover scaling pass; the step applies it twice, at its
    start and in ``apply_tstat``.  Returns (vel, eng_kin, chit,
    consint)."""
    dt = cfg.dt
    chit = chit + dt * (eng_kin - cfg.te_kin) * cfg.rqmass
    tscale = 1.0 - dt * chit
    vel = vel * tscale
    eng_kin = eng_kin * tscale * tscale
    consint = consint + dt * chit * cfg.qmass_tau2
    chit = chit + dt * (eng_kin - cfg.te_kin) * cfg.rqmass
    return vel, eng_kin, chit, consint


def _rand_uvect_from(u, v):
    """Uniform unit vector from two uniforms (sphere point picking)."""
    z = 2.0 * u - 1.0
    rho = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * v
    return torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), z], -1)


def _angled_vector(v, cos_phi, theta):
    """Unit vector at angle acos(cos_phi) from v, rotated by theta around
    it, with a branch-free orthonormal basis."""
    v1 = v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-30)
    ax = torch.argmin(torch.abs(v1), dim=-1)
    # one_hot by comparison: F.one_hot on the CPU reads the ids' range
    # back to the host
    e = (ax[..., None] == torch.arange(3, device=ax.device)).to(v.dtype)
    v2 = torch.linalg.cross(v1, e, dim=-1)
    v2 = v2 * torch.rsqrt(torch.sum(v2 * v2, dim=-1, keepdim=True) + 1e-30)
    v3 = torch.linalg.cross(v1, v2, dim=-1)
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    ct, st = torch.cos(theta), torch.sin(theta)
    return (v1 * cos_phi[..., None]
            + sin_phi[..., None] * (ct[..., None] * v2 + st[..., None] * v3))


def tstat_radiative(cfg, ff, state, photons, gid=None, valid=None):
    """Radiative thermostat step: every atom absorbs one photon from the
    rotating table and, above 1e-4 eV of internal energy, re-emits 90% of
    it in a velocity-biased direction; then the thermal radius
    r = A/(B - min(E, mxEng)) is refreshed.

    The noise is a pure function of (seed, step, global atom id) and
    equals the JAX package's bit for bit.  ``gid``: the global ids of the
    rows (default arange(n)); ``valid``: the filled slots of a slab, the
    others get no photon, engs 0 and radii 1.  Returns (vel, engs, radii,
    eng_temp, rng): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors; the inputs are checked first on both.
    """
    _check_inputs(cfg, ff, state, photons, gid, valid)
    dev = state.vel.device
    if dev.type == "cpu":
        return tstat_radiative_plain(cfg, ff, state, photons, gid, valid)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _radiative_cuda(cfg, ff, state, photons, gid, valid)


def _check_inputs(cfg, ff, state, photons, gid, valid):
    """Raise on what the kernel does not take: a float type other than
    f32 or f64, tables of another type, shapes that disagree, tensors on
    more than one device."""
    vel = state.vel
    dt = vel.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"the radiative thermostat takes f32 or f64, got "
                        f"{dt}")
    n = vel.shape[0]
    floats = {"engs": state.engs, "photons": photons,
              "spec_mass": ff.spec_mass, "spec_mx_eng": ff.spec_mx_eng,
              "spec_rad_a": ff.spec_rad_a, "spec_rad_b": ff.spec_rad_b}
    for name, t in floats.items():
        if t is None or t.dtype != dt:
            raise TypeError(f"{name} is {None if t is None else t.dtype}, "
                            f"the velocities {dt}")
    nsp = ff.spec_mass.shape
    want = {"vel": (vel, (n, 3)), "engs": (state.engs, (n,)),
            "types": (state.types, (n,)), "photons": (photons, (cfg.n_at,)),
            "spec_mx_eng": (ff.spec_mx_eng, nsp),
            "spec_rad_a": (ff.spec_rad_a, nsp),
            "spec_rad_b": (ff.spec_rad_b, nsp), "step": (state.step, ())}
    if gid is not None:
        want["gid"] = (gid, (n,))
    if valid is not None:
        want["valid"] = (valid, (n,))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, not "
                             f"{shape} for {n} rows and {cfg.n_at} atoms")
    if state.rng.ndim != 1 or state.rng.shape[0] < 1 or \
            state.rng.dtype != torch.int64:
        raise ValueError(f"rng: {tuple(state.rng.shape)} {state.rng.dtype}"
                         ", not a vector of int64 words")
    if valid is not None and valid.dtype != torch.bool:
        raise TypeError(f"valid is {valid.dtype}, not bool")
    devs = {t.device for t in [state.rng] + [t for t, _ in want.values()]
            + list(floats.values())}
    if len(devs) != 1:
        raise ValueError("the thermostat's tensors lie on "
                         f"{sorted(map(str, devs))}")


_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = cuda_build.load("tstat")
    if lib.aztotmd_tstat_radiative_f32.argtypes is None:
        for name in ("f32", "f64"):
            fn = getattr(lib, "aztotmd_tstat_radiative_" + name)
            fn.argtypes = [_P] * 12 + [_I] * 3 + [_P] * 5
            fn.restype = ctypes.c_int
    return lib


def _radiative_cuda(cfg, ff, state, photons, gid, valid):
    """Launch csrc/tstat.cu into new output tensors; the internal-energy
    sum is torch.sum of its engs, as in the plain version."""
    global launches
    c = lambda t: None if t is None else t.contiguous()
    i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    vel, engs, rng = c(state.vel), c(state.engs), c(state.rng)
    tables = [c(t) for t in (photons, ff.spec_mass, ff.spec_mx_eng,
                             ff.spec_rad_a, ff.spec_rad_b)]
    outs = (torch.empty_like(vel), torch.empty_like(engs),
            torch.empty_like(engs), torch.empty_like(rng))
    lib = _lib()
    fn = lib.aztotmd_tstat_radiative_f64 if vel.dtype == torch.float64 \
        else lib.aztotmd_tstat_radiative_f32
    err = fn(vel.data_ptr(), engs.data_ptr(), i32(state.types).data_ptr(),
             *(t.data_ptr() for t in tables), rng.data_ptr(),
             i32(state.step).data_ptr(),
             ptr(i32(gid)), ptr(c(valid)), vel.shape[0],
             cfg.n_at, rng.shape[0], *(t.data_ptr() for t in outs),
             torch.cuda.current_stream(vel.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"thermostat kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    vel, engs, radii, rng = outs
    return vel, engs, radii, torch.sum(engs), rng


def tstat_radiative_plain(cfg, ff, state, photons, gid=None, valid=None):
    """What the kernel computes, in torch ops (f32 or f64, any device);
    the arguments and results of ``tstat_radiative``."""
    dt = state.pos.dtype
    dev = state.pos.device
    types = state.types.long()
    n = types.shape[0]
    mass = ff.spec_mass[types]
    vel = state.vel
    engs = state.engs

    if gid is None:
        gid = torch.arange(n, device=dev)
    u = prng.uniform4_16(state.rng[-1], state.step, gid, dt)
    rng = state.rng.clone()
    rng[0] = (rng[0] + prng.GOLD) & prng.MASK32

    # rotating photon index: pe[i] = photons[(i + shift) % N] with
    # shift = (step * stride mod 2^32) mod N (= roll(photons, -shift))
    N = cfg.n_at
    shift = prng._mul32(state.step.to(torch.int64) & prng.MASK32,
                        _PHOTON_STRIDE) % N
    pe = photons[((gid.to(torch.int64) & prng.MASK32) + shift) % N]
    if valid is not None:
        pe = torch.where(valid, pe, torch.zeros_like(pe))

    # --- absorb ---
    v02 = torch.sum(vel * vel, dim=-1)
    uvec = _rand_uvect_from(u[:, 0], u[:, 1])
    vel = vel + (pe * REV_LIGHT / mass)[:, None] * uvec
    v12 = torch.sum(vel * vel, dim=-1)
    engs = engs + pe + 0.5 * mass * (v02 - v12)

    # --- radiate ---
    do_rad = engs > 1e-4
    v02 = v12
    rv0 = torch.rsqrt(torch.clamp(v02, min=1e-30))
    ph = 0.9 * engs
    ermc = ph * REV_LIGHT / mass
    ermcv0 = ermc * rv0
    # random cosine in [-1, 1 - 2*ermc/v0] (momentum bias)
    xi = u[:, 2]
    cos_phi = torch.where(ermcv0 >= 1.0, torch.full_like(xi, -1.0),
                          xi * 2.0 * (1.0 - torch.clamp(ermcv0, max=1.0))
                          - 1.0)
    theta = (2.0 * math.pi) * u[:, 3]
    rv = _angled_vector(vel, cos_phi, theta)
    vel_r = vel + ermc[:, None] * rv
    v12 = torch.sum(vel_r * vel_r, dim=-1)
    engs_r = engs - (ph + 0.5 * mass * (v12 - v02))
    vel = torch.where(do_rad[:, None], vel_r, vel)
    engs = torch.where(do_rad, engs_r, engs)

    # --- thermal radius ---
    rest = torch.minimum(engs, ff.spec_mx_eng[types])
    radii = ff.spec_rad_a[types] / (ff.spec_rad_b[types] - rest)
    if valid is not None:
        engs = torch.where(valid, engs, torch.zeros_like(engs))
        radii = torch.where(valid, radii, torch.ones_like(radii))
    return vel, engs, radii, torch.sum(engs), rng


def apply_tstat(cfg, ff, state, eng_kin, photons=None):
    """End-of-step thermostat: the equilibration rescale every
    freq_equil steps while step <= n_equil, then the configured
    thermostat.  Returns a dict of state updates plus "_eng_kin" (and
    "_eng_temp" under the radiative thermostat)."""
    vel = state.vel
    upd = {}
    if cfg.n_equil and cfg.freq_equil:
        do_scale = (state.step <= cfg.n_equil) & \
            (state.step % cfg.freq_equil == 0)
        vel_s, ek_s = temp_scale(cfg, vel, eng_kin)
        vel = torch.where(do_scale, vel_s, vel)
        eng_kin = torch.where(do_scale, ek_s, eng_kin)

    if cfg.tstat_type == TSTAT_NOSE:
        vel, eng_kin, chit, consint = nose_apply(
            cfg, vel, eng_kin, state.chit, state.consint)
        upd.update(chit=chit, consint=consint)
    elif cfg.tstat_type == TSTAT_RADI:
        vel, engs, radii, eng_temp, rng = tstat_radiative(
            cfg, ff, state.replace(vel=vel), photons)
        upd.update(engs=engs, radii=radii, rng=rng, _eng_temp=eng_temp)
    upd.update(vel=vel, _eng_kin=eng_kin)
    return upd
