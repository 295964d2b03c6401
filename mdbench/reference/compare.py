"""The numbers that decide ``correct``: gaps between what the run produced
and the plain reference, each against a limit of its own (the cell's
``limits``; the readings each was set from are in PERF.md).

- ``start``: the loaded state (positions, velocities and, under the
  radiative thermostat, the photon table) against the reference's own
  read of the deck and draws from the seed: the largest gap, positions
  over the box, the others over their largest reference value;
- after one step of the run's own captured step program from the state
  the window ended in, against the reference's step from the same state:
  ``pos_A`` the largest position gap in A (minimum image); ``vel``,
  ``tstat`` and ``force`` (the run's forces against the reference's pair
  pass at the run's own positions) the largest gap over the reference's
  largest value; ``tstat`` is the thermostat's state: under the radiative
  thermostat the internal energies, and the thermal radii where the
  potential reads them; under Nose-Hoover the friction ``chit`` and its
  integral ``consint``, each over its reference magnitude but no less
  than the thermostat's own scale (chit's equilibrium spread 1 / (tau
  sqrt(deg_free)), and the target kinetic energy for consint), so that a
  value passing through zero does not blow the ratio up; ``energy`` the
  step's energies
  against the reference's (the pair energy at the run's positions), the
  largest gap over |kin| + sum |pair energy| + |internal energy|, and no
  less than the gap between the window's last stat row, as the device
  ring packed it and stat.dat holds it, and the energies of the state
  that row was read from (what decoding did to them);
- ``rdf``: one RDF sample by the run's own captured sampler of the state
  the window ended in against the reference's count of the same
  positions, the sum of gaps over the reference's sum;
- ``rows``: stat rows of the run up to the window's end missing,
  repeated or out of order (exact: limit 0).
"""

from __future__ import annotations

import torch

from .md import min_image

NAMES = ("start", "pos_A", "vel", "force", "energy", "tstat", "rdf", "rows")
ENERGY_COLS = ("tot", "kin", "vdw", "coul1", "coul2", "temp")


def _rel_max(a, b):
    a, b = a.double(), b.double()
    den = float(b.abs().max())
    gap = float((a - b).abs().max())
    return gap / den if den > 0 else gap


def _rel_floor(a, b, floor: float) -> float:
    """The largest gap of ``a`` from ``b`` over max(max |b|, ``floor``)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), floor)


def start_gap(run: dict, ref: dict, box: float) -> float:
    dx = min_image(run["x"].double() - ref["x"].double(), box)
    gap = max(float(dx.abs().max()) / box, _rel_max(run["v"], ref["v"]))
    if "photons" in ref:
        gap = max(gap, _rel_max(run["photons"], ref["photons"]))
    return gap


def tstat_gap(ref, run: dict, s_ref: dict) -> float:
    """The thermostat's state after the step against the reference's."""
    if ref.nose:
        chit_scale = 1.0 / (ref.p["tau"] * ref.deg_free ** 0.5)
        return max(_rel_floor(run["chit"], s_ref["chit"], chit_scale),
                   _rel_floor(run["consint"], s_ref["consint"], ref.te_kin))
    gap = _rel_max(run["engs"], s_ref["engs"])
    if ref.surkov:
        gap = max(gap, _rel_max(run["radii"], s_ref["radii"]))
    return gap


def judge(ref, run: dict, s_ref: dict, eng: dict, hist, x_hist,
          box: float) -> dict:
    """The numbers of one checked step and one RDF sample: ``run`` ({"x",
    "v", "f" and the thermostat's state, "engs" and "radii" or "chit" and
    "consint", after the step) with the energies ``eng`` it reports,
    against the float64 reference ``ref`` and its state ``s_ref`` after
    the same step; ``hist`` the run's RDF sample of the positions
    ``x_hist``."""
    # the positions the run's pair pass read ("x_f": a control stage's)
    f_ref, vdw, vdw_abs = ref.forces(run.get("x_f", run["x"]),
                                     s_ref["radii_in"])
    dx = min_image(run["x"].double() - s_ref["x"].double(), box)
    tstat = tstat_gap(ref, run, s_ref)
    e = s_ref["energies"]
    want = {"kin": float(e["kin"]), "vdw": float(vdw),
            "temp": float(e["temp"]), "coul1": 0.0, "coul2": 0.0}
    want["tot"] = want["vdw"] + want["kin"]
    scale = abs(want["kin"]) + float(vdw_abs) + abs(want["temp"])
    energy = max(abs(float(eng[k]) - want[k]) for k in ENERGY_COLS) / scale
    h_ref = ref.rdf_hist(x_hist).double()
    h = torch.as_tensor(hist).double().reshape(-1).to(h_ref.device)
    return {"pos_A": float(dx.abs().max()),
            "vel": _rel_max(run["v"], s_ref["v"]),
            "force": _rel_max(run["f"], f_ref),
            "energy": energy, "tstat": tstat,
            "rdf": float((h - h_ref).abs().sum() / h_ref.abs().sum()),
            "scale": scale}


def row_gap(row: dict, eng: dict, scale: float) -> float:
    """A decoded stat row against the energies of the state it was read
    from, the largest gap over ``scale``, over the columns the row has."""
    return max(abs(float(row[k]) - float(eng[k])) for k in row) / scale


def verdict(numbers: dict, limits: dict):
    """(correct, {name: [value, limit]}): every number at or under its
    limit; a number that is missing or not finite fails."""
    out = {}
    ok = True
    for k in NAMES:
        v = numbers.get(k)
        lim = limits[k]
        good = v is not None and v == v and abs(v) != float("inf") \
            and v <= lim
        ok = ok and good
        out[k] = [v, lim]
    return ok, out
