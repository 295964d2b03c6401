"""The radiative thermostat's CUDA kernel (``csrc/tstat.cu``) against its
plain version, ``ops/thermostat.py::tstat_radiative_plain``, on identical
inputs, and the wrapper's checks.

The ``cuda`` tests need a card and skip without one; this file imports no
jax, so on the GPU machine run them with ``python -m pytest
tests/test_torch_tstat_kernel.py -m cuda -q --noconftest``.  The other
tests run on the CPU.

Tolerances on the card: velocities within 2e-6 (f32) or 1e-13 (f64) of
each atom's velocity scale, |v_in| plus the absorbed and emitted kicks'
largest sizes, and internal energies within the same share of each
atom's energy scale, |E_in| plus its photon plus its kinetic energy:
per atom, because a cold atom's whole velocity is the kick, which a
16-bit step of any uniform moves by ~1e-4 of itself.  Thermal radii
within the same share of themselves.  Not bit for bit: torch's CUDA
cross product contracts a * b - c * d into an FMA, the kernel rounds
every operation (its 3-sums follow torch's CUDA order, (x^2 + z^2) +
y^2).  The rng words, the 16-bit uniforms recovered from the kicks of
cold atoms that do not radiate, and which atoms radiate are exactly
equal.
"""

import math
import types

import numpy as np
import pytest
import torch

from aztotmd_tpu_torch.ops import prng, thermostat
from aztotmd_tpu_torch.runtime import graph

torch.set_num_threads(1)

M32 = 0xFFFFFFFF
STEP = 1_000_003
# species: mass (eV ps^2 / A^2, argon 0.0041), mxEng, radA, radB
SPECIES = [(0.0041, 1.0, 2.885, 5.0), (0.0020, 0.6, 1.9, 4.0),
           (0.0066, 1.4, 3.3, 6.5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def photon_rows(n_at, step, gid):
    """The photon-table index each row reads at ``step`` (the kernel's
    rotation, in numpy)."""
    shift = ((step * thermostat._PHOTON_STRIDE) & M32) % n_at
    return ((gid.astype(np.int64) & M32) + shift) % n_at


def make_inputs(n_at, nsp, dtype, slab, seed=0, step=STEP):
    """(cfg, ff, state, photons, gid, valid) of ``n_at`` atoms, numpy-
    seeded, in ``dtype`` on the CPU.  With ``slab`` the atoms fill a
    quarter more rows than atoms, in random order, as a slab's slots do
    (gid -1 and valid False in the empty ones).  A third of the atoms
    start cold (velocity 0); a sixth of those are probes that absorb a
    photon of 1e-5 to 5e-5 eV from no internal energy and so stay under
    the 1e-4 eV threshold, another sixth sit within 2e-6 eV of it on
    either side after the photon, and the rest emit with ermc/v0 >= 1.
    The warm atoms carry 0 to 0.3 eV and thermal velocities."""
    rng = np.random.default_rng(seed)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    n = n_at + (n_at + 3) // 4 if slab else n_at
    gid = np.full(n, -1, np.int64)
    gid[rng.permutation(n)[:n_at] if slab else slice(None)] = np.arange(n_at)
    typ = rng.integers(0, nsp, n).astype(np.int32)
    mass = np.array([s[0] for s in SPECIES[:nsp]])
    photons = np.minimum(rng.gamma(5.0, 0.04, n_at), 1.0)
    vel = rng.normal(0.0, 5.0, (n, 3))
    engs = rng.uniform(0.0, 0.3, n)
    cold = rng.random(n) < 1 / 3
    vel[cold] = 0.0
    live = gid >= 0
    ph_row = photon_rows(n_at, step, np.maximum(gid, 0))
    kind = rng.integers(0, 6, n)
    probe = cold & live & (kind == 0)
    photons[ph_row[probe]] = rng.uniform(1e-5, 5e-5, probe.sum())
    engs[probe] = 0.0
    edge = cold & live & (kind == 1)
    photons[ph_row[edge]] = rng.uniform(1e-5, 9e-5, edge.sum())
    side = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    engs[edge] = 1e-4 - photons[ph_row[edge]] + side[edge] * 2e-6
    as_t = lambda a: torch.as_tensor(np.asarray(a, npdt))
    ff = types.SimpleNamespace(**{
        k: as_t([s[j] for s in SPECIES[:nsp]])
        for j, k in enumerate(("spec_mass", "spec_mx_eng", "spec_rad_a",
                               "spec_rad_b"))})
    state = types.SimpleNamespace(
        pos=as_t(rng.uniform(0.0, 30.0, (n, 3))), vel=as_t(vel),
        engs=as_t(engs), types=torch.as_tensor(typ),
        rng=torch.tensor([0xFFFFFFF0, 0xDEADBEEF], dtype=torch.int64),
        step=torch.tensor(step, dtype=torch.int32))
    cfg = types.SimpleNamespace(n_at=n_at)
    meta = {"mass": mass[typ], "probe": probe, "edge": edge}
    if not slab:
        return cfg, ff, state, as_t(photons), None, None, meta
    return (cfg, ff, state, as_t(photons), torch.as_tensor(gid,
            dtype=torch.int32), torch.as_tensor(live), meta)


def to(dev, inputs):
    mv = lambda t: t.to(dev) if torch.is_tensor(t) else t
    cfg, ff, st, ph, gid, valid, meta = inputs
    ff = types.SimpleNamespace(**{k: mv(v) for k, v in vars(ff).items()})
    st = types.SimpleNamespace(**{k: mv(v) for k, v in vars(st).items()})
    return cfg, ff, st, mv(ph), mv(gid), mv(valid), meta


def emitted(state, photons, gid, meta, out):
    """Energy each atom gave off (f64): internal plus kinetic energy in,
    plus its photon, less both out; ~0 unless it radiated."""
    n_at = photons.shape[0]
    g = np.arange(state.vel.shape[0]) if gid is None else \
        np.maximum(gid.cpu().numpy(), 0)
    pe = photons.double().cpu().numpy()[photon_rows(n_at, int(state.step),
                                                    g)]
    m = meta["mass"]
    ke = lambda v: 0.5 * m * (v.double().cpu().numpy() ** 2).sum(-1)
    return (state.engs.double().cpu().numpy() + ke(state.vel) + pe
            - out[1].double().cpu().numpy() - ke(out[0]))


def scales(state, photons, gid, meta):
    """Each atom's velocity and energy scales of the tolerance."""
    n_at = photons.shape[0]
    g = np.arange(state.vel.shape[0]) if gid is None else \
        np.maximum(gid.cpu().numpy(), 0)
    pe = photons.double().cpu().numpy()[photon_rows(n_at, int(state.step),
                                                    g)]
    m = meta["mass"]
    v = state.vel.double().cpu().numpy()
    e_scale = (np.abs(state.engs.double().cpu().numpy()) + pe
               + 0.5 * m * (v ** 2).sum(-1))
    v_scale = (np.sqrt((v ** 2).sum(-1))
               + (pe + e_scale) * thermostat.REV_LIGHT / m)
    return v_scale, e_scale


def recovered_uniforms(out, state, photons, meta):
    """(u0, u1) x 65536 of the probe atoms, read back from their kicks:
    a cold atom that does not radiate leaves with k (rho cos phi, rho
    sin phi, 2 u0 - 1), k = photon / c / mass."""
    p = meta["probe"]
    n_at = photons.shape[0]
    g = np.arange(state.vel.shape[0])
    pe = photons.double().cpu().numpy()[photon_rows(n_at, int(state.step),
                                                    g)]
    k = pe * thermostat.REV_LIGHT / meta["mass"]
    v = out[0].double().cpu().numpy()
    z = v[:, 2] / k
    phi = np.mod(np.arctan2(v[:, 1], v[:, 0]), 2 * math.pi)
    u0 = (z + 1.0) / 2.0 * 65536
    u1 = phi / (2 * math.pi) * 65536
    keep = p & (np.abs(z) < 1.0 - 1e-4)
    return np.rint(u0[keep]), np.mod(np.rint(u1[keep]), 65536), keep


CASES = [(1, 1), (257, 3), (4000, 1), (4000, 3)]


def _id(c):
    return f"n{c[0]}-nsp{c[1]}"


# ----------------------------------------------------------------------
# CPU: the wrapper's dispatch and checks

@pytest.mark.parametrize("slab", [False, True], ids=["rows", "slab"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_cpu_tensors_take_the_plain_version(case, dtype, slab):
    cfg, ff, st, ph, gid, valid, _ = make_inputs(*case, dtype, slab)
    before = thermostat.launches
    got = thermostat.tstat_radiative(cfg, ff, st, ph, gid=gid, valid=valid)
    want = thermostat.tstat_radiative_plain(cfg, ff, st, ph, gid=gid,
                                            valid=valid)
    assert thermostat.launches == before
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_inputs_cover_both_branches_and_the_momentum_bias():
    """The inputs of the card tests reach what the kernel branches on:
    atoms that radiate and atoms that do not, both next to the 1e-4 eV
    threshold, cold atoms whose emission is bounded by ermc/v0 >= 1, and
    probes whose uniforms read back as the words give them."""
    inputs = make_inputs(4000, 3, torch.float64, False)
    cfg, ff, st, ph, gid, valid, meta = inputs
    out = thermostat.tstat_radiative_plain(cfg, ff, st, ph)
    rad = emitted(st, ph, gid, meta, out) > 4.5e-5
    edge = meta["edge"]
    assert rad[edge].sum() >= 20 and (~rad[edge]).sum() >= 20
    assert not rad[meta["probe"]].any()
    assert rad[~meta["probe"] & ~edge].mean() > 0.99
    # cold emitters: 0.9 (E + pe) / pe >= 1, so cos_phi = -1
    cold = (st.vel == 0).all(-1).numpy() & ~meta["probe"] & ~edge
    n_at = cfg.n_at
    pe = ph.numpy()[photon_rows(n_at, STEP, np.arange(n_at))]
    e_abs = st.engs.numpy() + pe
    assert (0.9 * e_abs[cold] / pe[cold] > 1.05).sum() >= 100
    u = prng.uniform4_16(st.rng[-1], st.step, torch.arange(n_at),
                         torch.float64).numpy() * 65536
    u0, u1, keep = recovered_uniforms(out, st, ph, meta)
    assert keep.sum() >= 50
    np.testing.assert_array_equal(u0, u[keep, 0])
    np.testing.assert_array_equal(u1, u[keep, 1])


def _bad(kind):
    cfg, ff, st, ph, gid, valid, _ = make_inputs(257, 3, torch.float32,
                                                 kind.startswith("slab"))
    if kind == "f16":
        st.vel, st.engs, ph = st.vel.half(), st.engs.half(), ph.half()
        for k, v in vars(ff).items():
            setattr(ff, k, v.half())
    elif kind == "table_f64":
        ff.spec_rad_a = ff.spec_rad_a.double()
    elif kind == "vel_shape":
        st.vel = st.vel[:, :2]
    elif kind == "engs_rows":
        st.engs = st.engs[:-1]
    elif kind == "photons":
        ph = ph[:-1]
    elif kind == "slab_gid":
        gid = gid[:-1]
    elif kind == "slab_valid":
        valid = valid.to(torch.int32)
    elif kind == "rng":
        st.rng = st.rng.to(torch.int32)
    return cfg, ff, st, ph, gid, valid


@pytest.mark.parametrize("kind,err", [
    ("f16", TypeError), ("table_f64", TypeError), ("vel_shape", ValueError),
    ("engs_rows", ValueError), ("photons", ValueError),
    ("slab_gid", ValueError), ("slab_valid", TypeError),
    ("rng", ValueError)])
def test_wrapper_refuses_before_any_launch(kind, err):
    cfg, ff, st, ph, gid, valid = _bad(kind)
    before = thermostat.launches
    with pytest.raises(err):
        thermostat.tstat_radiative(cfg, ff, st, ph, gid=gid, valid=valid)
    assert thermostat.launches == before


def test_launch_counters_list_the_thermostat():
    assert (thermostat, "launches") in graph.launch_counters()


# ----------------------------------------------------------------------
# the card: kernel against plain on the same CUDA tensors

TOL = {torch.float32: 2e-6, torch.float64: 1e-13}


def _hold(inputs, got, want, uniforms=True):
    cfg, ff, st, ph, gid, valid, meta = inputs
    tol = TOL[st.vel.dtype]
    assert torch.equal(got[4], want[4])            # rng words
    v_scale, e_scale = scales(st, ph, gid, meta)
    gv, pv = (x.double().cpu().numpy() for x in (got[0], want[0]))
    ge, pe = (x.double().cpu().numpy() for x in (got[1], want[1]))
    gr, pr = (x.double().cpu().numpy() for x in (got[2], want[2]))
    assert (np.abs(gv - pv).max(-1) <= tol * v_scale).all()
    assert (np.abs(ge - pe) <= tol * e_scale).all()
    assert (np.abs(gr - pr) <= tol * np.abs(pr)).all()
    assert abs(float(got[3]) - float(want[3])) <= tol * e_scale.sum()
    rad_k = emitted(st, ph, gid, meta, got) > 4.5e-5
    rad_p = emitted(st, ph, gid, meta, want) > 4.5e-5
    np.testing.assert_array_equal(rad_k, rad_p)
    if uniforms and gid is None:
        for a, b in zip(recovered_uniforms(got, st, ph, meta)[:2],
                        recovered_uniforms(want, st, ph, meta)[:2]):
            np.testing.assert_array_equal(a, b)
    if valid is not None:
        empty = ~valid
        assert torch.all(got[1][empty] == 0) and torch.all(got[2][empty] == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("slab", [False, True], ids=["rows", "slab"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES + [(40000, 3)], ids=_id)
def test_kernel_matches_plain(cuda, case, dtype, slab):
    inputs = to(cuda, make_inputs(*case, dtype, slab, seed=case[0]))
    cfg, ff, st, ph, gid, valid, _ = inputs
    before = thermostat.launches
    got = thermostat.tstat_radiative(cfg, ff, st, ph, gid=gid, valid=valid)
    assert thermostat.launches == before + 1
    want = thermostat.tstat_radiative_plain(cfg, ff, st, ph, gid=gid,
                                            valid=valid)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape \
            and a.device == b.device
    _hold(inputs, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_graph_replays_advance_the_step(cuda, dtype):
    """A captured step of the thermostat, replayed 3 times over a static
    state whose step it advances, gives the plain version's three
    results, each from the state the replay before left;
    ``thermostat.launches`` rises by one a replay."""
    inputs = to(cuda, make_inputs(4000, 3, dtype, False, seed=5))
    cfg, ff, st, ph, _, _, meta = inputs
    radii = torch.empty_like(st.engs)
    eng_temp = torch.empty((), dtype=dtype, device=cuda)

    def body():
        vel, engs, r, et, rng = thermostat.tstat_radiative(cfg, ff, st, ph)
        for dst, src in ((st.vel, vel), (st.engs, engs), (radii, r),
                         (eng_temp, et), (st.rng, rng)):
            dst.copy_(src)
        st.step.add_(1)
    prog = graph.Program("tstat", body,
                         lambda: thermostat.tstat_radiative(cfg, ff, st, ph),
                         cuda)
    before = thermostat.launches
    for k in range(1, 4):
        ref = types.SimpleNamespace(**{n: v.clone()
                                       for n, v in vars(st).items()})
        want = thermostat.tstat_radiative_plain(cfg, ff, ref, ph)
        prog.replay()
        torch.cuda.synchronize()
        assert thermostat.launches == before + k
        assert int(st.step) == STEP + k
        _hold((cfg, ff, ref, ph, None, None, meta),
              (st.vel, st.engs, radii, eng_temp, st.rng), want,
              uniforms=k == 1)
