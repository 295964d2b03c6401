"""Text writers matching the reference's output formats (the port's copy
of the writers it uses from ``aztotmd_tpu/output/writers.py``).  traj.dat
and revcon.xyz go through the port's native row formatter (``native.py``,
built from ``csrc/aztocore.cpp`` at first use), as the JAX package's do
through its own; the other files are written in Python.

Every writer documents the reference function it mirrors; formats are
tab-separated with ``%f``-style 6-decimal floats, matching fprintf
defaults so downstream tooling sees identical files.
"""

from __future__ import annotations

import os

import numpy as np


def _f(x) -> str:
    """C printf %f: fixed 6 decimals."""
    return f"{float(x):.6f}"


class _FileWriter:
    def __init__(self, path, append: bool = False):
        self.path = path
        # line-buffered: rows survive an interrupted run (the runner can
        # be killed externally; the reference leaves the same tail risk
        # in its buffered flush, cuStat.cu:40)
        import os as _os
        self.appended = append and _os.path.exists(path) \
            and _os.path.getsize(path) > 0
        self.fh = open(path, "a" if self.appended else "w", buffering=1)

    def write_header(self, text: str):
        """Write the header only on fresh files (resumed runs append)."""
        if not self.appended:
            self.fh.write(text)

    def close(self):
        if self.fh:
            self.fh.close()
            self.fh = None


class StatWriter(_FileWriter):
    """stat.dat (reference: src/cuStat.cu:300-331 ``start_stat``,
    :40-71 ``copy_stat``; column order from prepare_stat_addr,
    cuStat.cu:241-261).

    Columns: time step engTot engKin engVdW engCoul1 engCoul2 [engTerm]
    [engBnd] [engAngle] momPx momNx momPy momNy momPz momNz press
    [varSpec counts...]
    """

    def __init__(self, path, fld, radi: bool, use_bnd: bool,
                 use_angl: bool, append: bool = False):
        super().__init__(path, append)
        self.radi, self.use_bnd, self.use_angl = radi, use_bnd, use_angl
        self.var_specs = [i for i, s in enumerate(fld.species)
                          if getattr(s, "varNumber", 0)]
        names = [fld.species[i].name for i in self.var_specs]

        h = "time\tstep\tengTot\tengKin\tengVdW\tengCoul1\tengCoul2"
        u = ("time, ps\tstep, n\tengTot, eV\tengKin, eV\tengVdW, eV"
             "\tengCoul1, eV\tengCoul2, eV")
        if radi:
            h += "\tengTerm"
            u += "\tengTerm, eV"
        if use_bnd:
            h += "\tengBnd"
            u += "\tengBnd, eV"
        if use_angl:
            h += "\tengAngle"
            u += "\tengAngle, eV"
        h += "\tmomPx\tmomNx\tmomPy\tmomNy\tmomPz\tmomNz\tpress"
        u += ("\tmomPx, eVps/A\tmomNx, eVps/A\tmomPy, eVps/A\tmomNy, eVps/A"
              "\tmomPz, eVps/A\tmomNz, eVps/A\tpress, atm")
        for nm in names:
            h += f"\t{nm}"
            u += f"\t{nm}"
        self.write_header(h + "\n" + u + "\n")

    def write_row(self, time, step, eng, pos_mom, neg_mom, press,
                  spec_number):
        cols = [_f(time), str(int(step)), _f(eng["tot"]), _f(eng["kin"]),
                _f(eng["vdw"]), _f(eng["coul1"]), _f(eng["coul2"])]
        if self.radi:
            cols.append(_f(eng["temp"]))
        if self.use_bnd:
            cols.append(_f(eng["bond"]))
        if self.use_angl:
            cols.append(_f(eng["angle"]))
        for k in range(3):
            cols += [_f(pos_mom[k]), _f(neg_mom[k])]
        cols.append(_f(press))
        for i in self.var_specs:
            cols.append(str(int(spec_number[i])))
        self.fh.write("\t".join(cols) + "\n")


class BondStatWriter(_FileWriter):
    """stat_bnd.dat (cuStat.cu:332-344; row layout from
    prepare_stat_addr :266-278): tot_bnd then per bond type (from 1)
    count / mean length / mean lifetime."""

    def __init__(self, path, fld, append: bool = False):
        super().__init__(path, append)
        h = "time\tstep\ttot_bnd"
        for b in fld.bonds[1:]:
            s1 = fld.species[b.spec1].name
            s2 = fld.species[b.spec2].name
            h += f"\tcnt{s1}-{s2}\tleng{s1}-{s2}\ttime{s1}-{s2}"
        self.write_header(h + "\n")

    def write_row(self, time, step, n_bond, bt_count, bt_r_mean, bt_lt_mean):
        cols = [_f(time), str(int(step)), str(int(n_bond))]
        for k in range(1, len(bt_count)):
            cols += [str(int(bt_count[k])), _f(bt_r_mean[k]),
                     _f(bt_lt_mean[k])]
        self.fh.write("\t".join(cols) + "\n")


class MsdWriter(_FileWriter):
    """msd.dat (cuStat.cu:345-350; prepare_stat_addr :280-289): per
    species the six box-crossing counters px nx py ny pz nz."""

    def __init__(self, path, fld, append: bool = False):
        super().__init__(path, append)
        h = "time\tstep"
        for s in fld.species:
            h += f"\t{s.name}_px\tnx\tpy\tny\tpz\tnz"
        self.write_header(h + "\n")

    def write_row(self, time, step, cross_pos, cross_neg):
        cols = [_f(time), str(int(step))]
        for i in range(cross_pos.shape[0]):
            for k in range(3):
                cols += [str(int(cross_pos[i, k])),
                         str(int(cross_neg[i, k]))]
        self.fh.write("\t".join(cols) + "\n")


class JumpWriter(_FileWriter):
    """jumps.dat (cuStat.cu:353-358; prepare_stat_addr :292-297):
    nTot / pos / neg electron-jump counters."""

    def __init__(self, path, append: bool = False):
        super().__init__(path, append)
        self.write_header("time\tstep\tnTot\tpos\tneg\n")

    def write_row(self, time, step, n_jump, jump_pos, jump_neg):
        self.fh.write(f"{_f(time)}\t{int(step)}\t{int(n_jump)}"
                      f"\t{int(jump_pos)}\t{int(jump_neg)}\n")


class TrajWriter:
    """traj.dat (cuStat.cu:808-875 write_traj/copy_traj/start_traj):
    per sampled step one row: time, step, then per atom
    x y z type ptype (ptype = type of the parent atom, -1 if none),
    formatted by the native row formatter from float32 positions."""

    def __init__(self, path, fld, types):
        from ..native import NativeRowFile
        self.path = path
        self._native = NativeRowFile(path)
        h = "time\tstep"
        for t in types:
            h += f"\t{fld.species[int(t)].name}x\ty\tz\ttype\tptype"
        self._native.write_str(h)

    def write_row(self, time, step, pos, types, parents):
        ptype = np.where(parents > 0, types[np.maximum(parents, 0)],
                         -1).astype(np.int32)
        self._native.write_traj_row(time, step, pos, types, ptype)

    def close(self):
        if self._native:
            self._native.close()
            self._native = None


class HistWriter(_FileWriter):
    """hist.dat (serial build: out_md.cpp:12-17 history_header;
    main.cpp:166): per-sample history line — total energy, temperature,
    atom[1] x/y/charge, wall momenta."""

    def __init__(self, path):
        super().__init__(path)
        self.fh.write("time iStep totEn temp atm1x atm1y atm1ch "
                      "momXn momXp momYn momYp momZn momZp\n"
                      "time,ps iStep totEn,eV temp,K atm[1].x,A "
                      "atm[1].y,A atm1ch,e momXn momXp momYn momYp "
                      "momZn momZp\n")

    def write_row(self, time, step, tot, temp, x1, y1, q1,
                  neg_mom, pos_mom):
        vals = [tot, temp, x1, y1, q1]
        for k in range(3):
            vals += [neg_mom[k], pos_mom[k]]
        self.fh.write(" ".join([_f(time), str(int(step))]
                               + [_f(v) for v in vals]) + "\n")


class VafWriter(_FileWriter):
    """vaf.dat (serial build: out_md.cpp:536-583 vaf_header/vaf_info):
    per-species velocity autocorrelation <v(t)·v(0)>."""

    def __init__(self, path, fld, vel0, types, n_spec):
        super().__init__(path)
        self.fh.write("time,ps\tiStep"
                      + "".join(f"\t{s.name}" for s in fld.species) + "\n")
        self.vel0 = np.asarray(vel0, np.float64)
        self.types = np.asarray(types)
        self.counts = np.bincount(self.types, minlength=n_spec)
        self.n_spec = n_spec

    def write_row(self, time, step, vel):
        dots = np.sum(np.asarray(vel, np.float64) * self.vel0, axis=1)
        acc = np.zeros(self.n_spec)
        np.add.at(acc, self.types, dots)
        acc = np.divide(acc, self.counts,
                        out=np.zeros_like(acc), where=self.counts > 0)
        self.fh.write("\t".join([_f(time), str(int(step))]
                                + [_f(v) for v in acc]) + "\n")


class MsdDisplWriter(_FileWriter):
    """Displacement MSD (serial build: out_md.cpp:89-124 out_msd with
    msd_header :20-30): per species mean |r(t)-r(0)|^2 (minimum image)
    plus the x box-crossing counters."""

    def __init__(self, path, fld, pos0, types, box, n_spec):
        super().__init__(path)
        h = "Time\tStep"
        for s in fld.species:
            h += f"\t{s.name}-msd\t{s.name}-nOyz\t{s.name}-pOyz"
        self.fh.write(h + "\n")
        self.pos0 = np.asarray(pos0, np.float64)
        self.types = np.asarray(types)
        self.box = np.asarray(box)
        self.counts = np.bincount(self.types, minlength=n_spec)
        self.n_spec = n_spec

    def write_row(self, time, step, pos, cross_neg, cross_pos):
        d = np.asarray(pos, np.float64) - self.pos0
        d -= self.box * np.round(d / self.box)
        r2 = np.sum(d * d, axis=1)
        acc = np.zeros(self.n_spec)
        np.add.at(acc, self.types, r2)
        acc = np.divide(acc, self.counts,
                        out=np.zeros_like(acc), where=self.counts > 0)
        self.write_row_msd(time, step, acc, cross_neg, cross_pos)

    def write_row_msd(self, time, step, msd, cross_neg, cross_pos):
        """Row from per-species MSD values computed on device (the stat
        ring path — avoids pulling the full position array per sample)."""
        cols = [_f(time), str(int(step))]
        for i in range(self.n_spec):
            cols += [_f(msd[i]), str(int(cross_neg[i, 0])),
                     str(int(cross_pos[i, 0]))]
        self.fh.write("\t".join(cols) + "\n")


class BindTrajWriter(_FileWriter):
    """traj_bnd.dat (cuStat.cu:921-1097): for every tracked atom (all
    atoms of the nucleus named in the ``bindtraj`` directive) one group
    of columns x y z type nbnd ptype px py pz r per sampled step, where
    p* describe the bonding partner ('parent'); empty columns when the
    atom has no parent (ptype -1)."""

    def __init__(self, path, n_atoms: int):
        super().__init__(path)
        self.fh.write("time\tstep"
                      + "\tx\ty\tz\ttype\tnbnd\tptype\tpx\tpy\tpz\tr"
                      * n_atoms)

    def write_row(self, time, step, idx, pos, types, nbonds, parents, box):
        box = np.asarray(box)
        out = [f"\n{_f(time)}\t{int(step)}"]
        for i in idx:
            x, y, z = pos[i]
            p = parents[i]
            if p > 0:
                px, py, pz = pos[p]
                d = pos[p] - pos[i]
                d -= box * np.round(d / box)
                r = float(np.sqrt(np.sum(d * d)))
                out.append(f"\t{_f(x)}\t{_f(y)}\t{_f(z)}\t{int(types[i])}"
                           f"\t{int(nbonds[i])}\t{int(types[p])}"
                           f"\t{_f(px)}\t{_f(py)}\t{_f(pz)}\t{_f(r)}")
            else:
                out.append(f"\t{_f(x)}\t{_f(y)}\t{_f(z)}\t{int(types[i])}"
                           f"\t{int(nbonds[i])}\t-1\t\t\t\t")
        self.fh.write("".join(out))


def write_rdf_file(path, rcfg, gr, names):
    """rdf.dat / rdf_n.dat (cuStat.cu:514-561 copy_rdf): header of
    species-pair names, then rows of (i+0.5)*dRDF and normalized g(r)."""
    n = len(names)
    with open(path, "w") as f:
        cols = ["r"]
        for i in range(n):
            for j in range(i, n):
                cols.append(f"{names[i]}-{names[j]}")
        f.write("\t".join(cols) + "\n")
        for i in range(rcfg.n_bin):
            row = [_f((i + 0.5) * rcfg.d_rdf)]
            row += [_f(v) for v in gr[i]]
            f.write("\t".join(row) + "\n")


def write_atoms_xyz(path, names, pos, box):
    """revcon.xyz (out_md.cpp:65-87 out_atoms + box.cpp save_box):
    count line, '1 la lb lc' box line, then name x y z."""
    from ..native import NativeRowFile
    header = (f"{len(names)}\n"
              f"1 {_f(box[0])} {_f(box[1])} {_f(box[2])}\n")
    f = NativeRowFile(path)
    f.write_str(header)
    f.write_xyz_rows(names, pos)
    f.close()


def _per_species_table(path, fld, types, columns, header_fn):
    """Shared layout of velocities.dat / tchars.dat (out_md.cpp:126-194):
    atoms grouped per species into parallel columns."""
    nsp = len(fld.species)
    groups = [np.flatnonzero(types == i) for i in range(nsp)]
    mx = max((len(g) for g in groups), default=0)
    with open(path, "w") as f:
        f.write("No" + header_fn() + "\n")
        for i in range(mx):
            row = [str(i + 1)]
            for j in range(nsp):
                if i < len(groups[j]):
                    row += [_f(c[groups[j][i]]) for c in columns]
                else:
                    row += [""] * len(columns)
            f.write("\t".join(row) + "\n")


def write_velocities(path, fld, types, vel):
    """velocities.dat (out_md.cpp:126-194 out_velocities): per species
    |v| vx vy vz columns."""
    speed = np.sqrt(np.sum(vel * vel, axis=1))

    def header():
        return "".join(f"\t{s.name}\tx\ty\tz" for s in fld.species)

    _per_species_table(path, fld, types,
                       [speed, vel[:, 0], vel[:, 1], vel[:, 2]], header)


def write_thermal_chars(path, fld, types, engs, radii):
    """tchars.dat (main.cu:51-118 out_thermalchar): per species thermal
    energy and radius columns (radiative thermostat only)."""

    def header():
        return "".join(f"\t{s.name}_eng\t{s.name}_rad" for s in fld.species)

    _per_species_table(path, fld, types, [engs, radii], header)


def write_cn(path, fld, ctl, types, pos, box):
    """CN.dat (out_md.cpp:389-505 out_cn): distribution of coordination
    numbers of 'counter' species around 'central' species within rCN.
    idCentral/idCounter are the 1-based positions of a species in the
    outCN directive's name lists (sys_init.cpp:890-929)."""
    if not ctl.out_cn:
        return
    sid = {s.name: i for i, s in enumerate(fld.species)}
    central = {k + 1: sid[nm] for k, nm in enumerate(ctl.cn_central)}
    counter = {k + 1: sid[nm] for k, nm in enumerate(ctl.cn_counter)}
    n_cen, n_cnt = len(central), len(counter)
    if not n_cen or not n_cnt:
        return
    box = np.asarray(box)
    r2cn = ctl.r2_cn
    id_cen_of_spec = np.zeros(len(fld.species), np.int64)
    id_cnt_of_spec = np.zeros(len(fld.species), np.int64)
    for k, i in central.items():
        id_cen_of_spec[i] = k
    for k, i in counter.items():
        id_cnt_of_spec[i] = k
    id_central = id_cen_of_spec[types]
    id_counter = id_cnt_of_spec[types]
    cen_idx = np.flatnonzero(id_central > 0)
    cnt_idx = np.flatnonzero(id_counter > 0)
    # CN counts per central atom and counter class
    cn = np.zeros((len(cen_idx), n_cnt + 1), np.int64)
    for a, i in enumerate(cen_idx):
        d = pos[cnt_idx] - pos[i]
        d -= box * np.round(d / box)
        r2 = np.sum(d * d, axis=1)
        near = cnt_idx[(r2 <= r2cn) & (cnt_idx != i)]
        for j in near:
            cn[a, id_counter[j]] += 1
    mx = int(cn[:, 1:].max()) if len(cen_idx) else 0
    n_pair = n_cen * n_cnt
    out = np.zeros((n_pair, mx + 1), np.int64)
    for a, i in enumerate(cen_idx):
        t0 = (id_central[i] - 1) * n_cnt
        for c in range(1, n_cnt + 1):
            out[t0 + c - 1, cn[a, c]] += 1
    with open(path, "w") as f:
        h = ["CN"]
        for ic in range(1, n_cen + 1):
            for jc in range(1, n_cnt + 1):
                h.append(f"{fld.species[central[ic]].name}-"
                         f"{fld.species[counter[jc]].name}")
        f.write("\t".join(h) + "\n")
        for v in range(mx + 1):
            f.write("\t".join([str(v)] + [str(out[p, v])
                                          for p in range(n_pair)]) + "\n")


def write_ncn(path, fld, ctl, types, pos, box):
    """nCN.dat (out_md.cpp:196-387 out_ncn): per-nucleus-pair CN
    distributions from the control.txt ``ncn`` section."""
    if not ctl.ncn_pairs:
        return
    box = np.asarray(box)
    n_nucl = len(fld.nnames)
    nucl_of = np.array([fld.species[t].nuclei for t in types])
    # per (nucleus, nucleus) cutoffs and output slots
    n = len(ctl.ncn_pairs)
    lig_order = np.zeros((n_nucl, n_nucl), np.int64)
    pair_ind = {}
    rad2 = np.zeros((n_nucl, n_nucl))
    n_lig = np.zeros(n_nucl, np.int64)
    nid = {nm: i for i, nm in enumerate(fld.nnames)}
    names = []
    for k, (nm1, nm2, r) in enumerate(ctl.ncn_pairs):
        id1, id2 = nid[nm1], nid[nm2]
        lig_order[id1][id2] = n_lig[id1] + 1
        pair_ind[(id1, n_lig[id1])] = k
        rad2[id1][id2] = r * r
        n_lig[id1] += 1
        names.append(f"{nm1}-{nm2}")
    mxlig = int(n_lig.max())
    coords = np.zeros((len(types), mxlig), np.int64)
    for i in range(len(types)):
        id1 = nucl_of[i]
        if not n_lig[id1] and not (lig_order[:, id1] > 0).any():
            continue
        d = pos - pos[i]
        d -= box * np.round(d / box)
        r2 = np.sum(d * d, axis=1)
        for j in np.flatnonzero(r2 > 0):
            id2 = nucl_of[j]
            k = lig_order[id1][id2]
            if k and r2[j] < rad2[id1][id2]:
                coords[i][k - 1] += 1
    mn, mx = 0, 0
    act = [i for i in range(len(types)) if n_lig[nucl_of[i]]]
    if act:
        vals = [coords[i][j] for i in act for j in range(n_lig[nucl_of[i]])]
        mn, mx = int(min(vals)), int(max(vals))
    out = np.zeros((n, mx - mn + 1), np.int64)
    for i in act:
        id1 = nucl_of[i]
        for j in range(n_lig[id1]):
            out[pair_ind[(id1, j)], coords[i][j] - mn] += 1
    with open(path, "w") as f:
        f.write("\t".join(["CN"] + names) + "\n")
        for v in range(mx - mn + 1):
            f.write("\t".join([str(mn + v)] + [str(out[p, v])
                                               for p in range(n)]) + "\n")


def write_bondlist(path, at1, at2, btypes):
    """revbonds.txt (bonds.cpp:112-123 save_bondlist)."""
    with open(path, "w") as f:
        f.write(f"{len(at1)}\n")
        for a, b, t in zip(at1, at2, btypes):
            f.write(f"{int(a)} {int(b)} {int(t)}\n")


def write_anglelist(path, central, lig1, lig2, atypes):
    """revangles.txt (angles.cpp:62-74 save_anglelist)."""
    with open(path, "w") as f:
        f.write(f"{len(central)}\n")
        for c, a, b, t in zip(central, lig1, lig2, atypes):
            f.write(f"{int(c)} {int(a)} {int(b)} {int(t)}\n")


def write_bond_lengths(path, fld, at1, at2, btypes, pos, box, n_bin=100):
    """lengths.dat (bonds.cpp ``bond_out``): histogram of bond lengths
    per bond type between its r2min and r2max."""
    box = np.asarray(box)
    nbt = len(fld.bonds)
    rmin = np.array([np.sqrt(b.r2min) if b.r2min > 0 else 0.0
                     for b in fld.bonds])
    rmax = np.array([np.sqrt(b.r2max) if np.isfinite(b.r2max)
                     and b.r2max < 1e17 else 3.0 for b in fld.bonds])
    hist = np.zeros((nbt, n_bin), np.int64)
    d = pos[at1] - pos[at2]
    d -= box * np.round(d / box)
    r = np.sqrt(np.sum(d * d, axis=1))
    for k in range(1, nbt):
        m = btypes == k
        if not m.any():
            continue
        e = np.clip(((r[m] - rmin[k]) / max(rmax[k] - rmin[k], 1e-9)
                     * n_bin).astype(int), 0, n_bin - 1)
        np.add.at(hist[k], e, 1)
    with open(path, "w") as f:
        names = [f"{fld.species[b.spec1].name}-{fld.species[b.spec2].name}"
                 for b in fld.bonds[1:]]
        f.write("r\t" + "\t".join(names) + "\n")
        for i in range(n_bin):
            row = []
            for k in range(1, nbt):
                rr = rmin[k] + (i + 0.5) * (rmax[k] - rmin[k]) / n_bin
                row.append(_f(rr) + "\t" + str(hist[k, i]))
            f.write("\t".join(row) + "\n")
