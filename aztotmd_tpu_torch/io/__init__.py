"""Deck parsers and writers for the reference text formats (the port's
copy of ``aztotmd_tpu/io``: the parsers and the writers ``write_atoms``,
``write_bondlist``, ``write_anglelist`` and ``atoms.write_velocities``,
with the JAX package's signatures; the runner's output writers are in
``output/writers.py``).

The module accepts the reference's decks byte-for-byte (control.txt,
field.txt, atoms.xyz, cuda.txt, bonds.txt, angles.txt).
"""

from .atoms import AtomsData, parse_atoms, parse_atoms_file, write_atoms
from .control import ControlSpec, ElecSpec, TStatSpec, parse_control, parse_control_file
from .device_cfg import DeviceConfig, parse_device_cfg, parse_device_cfg_dir
from .field import FieldSpec, SpeciesSpec, VdWSpec, parse_field, parse_field_file
from .toplists import (AngleList, BondList, parse_anglelist_file,
                       parse_bondlist_file, write_anglelist, write_bondlist)

__all__ = [
    "AtomsData", "parse_atoms", "parse_atoms_file", "write_atoms",
    "ControlSpec", "ElecSpec", "TStatSpec", "parse_control", "parse_control_file",
    "DeviceConfig", "parse_device_cfg", "parse_device_cfg_dir",
    "FieldSpec", "SpeciesSpec", "VdWSpec", "parse_field", "parse_field_file",
    "AngleList", "BondList", "parse_anglelist_file", "parse_bondlist_file",
    "write_anglelist", "write_bondlist",
]
