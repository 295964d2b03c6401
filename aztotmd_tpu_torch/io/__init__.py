"""Deck parsers for the reference text formats (the port's copy of the
parsers of ``aztotmd_tpu/io``, unchanged; the output writers are in
``output/writers.py``).

The module accepts the reference's decks byte-for-byte (control.txt,
field.txt, atoms.xyz, cuda.txt, bonds.txt, angles.txt).
"""

from .atoms import AtomsData, parse_atoms, parse_atoms_file
from .control import ControlSpec, ElecSpec, TStatSpec, parse_control, parse_control_file
from .device_cfg import DeviceConfig, parse_device_cfg, parse_device_cfg_dir
from .field import FieldSpec, SpeciesSpec, VdWSpec, parse_field, parse_field_file
from .toplists import (AngleList, BondList, parse_anglelist_file,
                       parse_bondlist_file)

__all__ = [
    "AtomsData", "parse_atoms", "parse_atoms_file",
    "ControlSpec", "ElecSpec", "TStatSpec", "parse_control", "parse_control_file",
    "DeviceConfig", "parse_device_cfg", "parse_device_cfg_dir",
    "FieldSpec", "SpeciesSpec", "VdWSpec", "parse_field", "parse_field_file",
    "AngleList", "BondList", "parse_anglelist_file", "parse_bondlist_file",
]
