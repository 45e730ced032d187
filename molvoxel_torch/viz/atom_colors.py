"""Element -> PyMOL color-name table for channel surfaces.

A copy of ``molvoxel_tpu/viz/atom_colors.py``: the common biochemistry
elements get explicit CPK-like PyMOL colors, and every other real element
resolves to PyMOL's built-in element color (named after the element, e.g.
``color praseodymium``), so all 118 elements have a color of their own.
"""

from __future__ import annotations

# All 118 element symbols in atomic-number order; PyMOL defines a built-in
# color named after each element (the reference's table is exactly this map).
_ELEMENT_NAMES = {
    "H": "hydrogen", "He": "helium", "Li": "lithium", "Be": "beryllium",
    "B": "boron", "C": "carbon", "N": "nitrogen", "O": "oxygen",
    "F": "fluorine", "Ne": "neon", "Na": "sodium", "Mg": "magnesium",
    "Al": "aluminum", "Si": "silicon", "P": "phosphorus", "S": "sulfur",
    "Cl": "chlorine", "Ar": "argon", "K": "potassium", "Ca": "calcium",
    "Sc": "scandium", "Ti": "titanium", "V": "vanadium", "Cr": "chromium",
    "Mn": "manganese", "Fe": "iron", "Co": "cobalt", "Ni": "nickel",
    "Cu": "copper", "Zn": "zinc", "Ga": "gallium", "Ge": "germanium",
    "As": "arsenic", "Se": "selenium", "Br": "bromine", "Kr": "krypton",
    "Rb": "rubidium", "Sr": "strontium", "Y": "yttrium", "Zr": "zirconium",
    "Nb": "niobium", "Mo": "molybdenum", "Tc": "technetium",
    "Ru": "ruthenium", "Rh": "rhodium", "Pd": "palladium", "Ag": "silver",
    "Cd": "cadmium", "In": "indium", "Sn": "tin", "Sb": "antimony",
    "Te": "tellurium", "I": "iodine", "Xe": "xenon", "Cs": "cesium",
    "Ba": "barium", "La": "lanthanum", "Ce": "cerium", "Pr": "praseodymium",
    "Nd": "neodymium", "Pm": "promethium", "Sm": "samarium",
    "Eu": "europium", "Gd": "gadolinium", "Tb": "terbium",
    "Dy": "dysprosium", "Ho": "holmium", "Er": "erbium", "Tm": "thulium",
    "Yb": "ytterbium", "Lu": "lutetium", "Hf": "hafnium", "Ta": "tantalum",
    "W": "tungsten", "Re": "rhenium", "Os": "osmium", "Ir": "iridium",
    "Pt": "platinum", "Au": "gold", "Hg": "mercury", "Tl": "thallium",
    "Pb": "lead", "Bi": "bismuth", "Po": "polonium", "At": "astatine",
    "Rn": "radon", "Fr": "francium", "Ra": "radium", "Ac": "actinium",
    "Th": "thorium", "Pa": "protactinium", "U": "uranium", "Np": "neptunium",
    "Pu": "plutonium", "Am": "americium", "Cm": "curium", "Bk": "berkelium",
    "Cf": "californium", "Es": "einsteinium", "Fm": "fermium",
    "Md": "mendelevium", "No": "nobelium", "Lr": "lawrencium",
    "Rf": "rutherfordium", "Db": "dubnium", "Sg": "seaborgium",
    "Bh": "bohrium", "Hs": "hassium", "Mt": "meitnerium",
    "Ds": "darmstadtium", "Rg": "roentgenium", "Cn": "copernicium",
    "Nh": "nihonium", "Fl": "flerovium", "Mc": "moscovium",
    "Lv": "livermorium", "Ts": "tennessine", "Og": "oganesson",
}

ELEMENT_COLORS = {
    "H": "white",
    "C": "gray",
    "N": "blue",
    "O": "red",
    "F": "palegreen",
    "Cl": "green",
    "Br": "firebrick",
    "I": "violet",
    "S": "yellow",
    "P": "orange",
    "B": "salmon",
    "Se": "chocolate",
    "Fe": "orange",
    "Zn": "slate",
    "Mg": "forest",
    "Ca": "gray",
    "Na": "purple",
    "K": "purple",
    "Cu": "brown",
    "Mn": "purple",
    "Co": "pink",
    "Ni": "green",
}

# a rotating palette for non-element channels (bond channels, features)
CHANNEL_PALETTE = [
    "tv_red", "tv_blue", "tv_green", "tv_yellow", "tv_orange",
    "purple", "cyan", "magenta", "salmon", "lime", "slate", "olive",
]


def atom_color(symbol: str) -> str:
    """Explicit CPK-ish color for common biochemistry elements, PyMOL's
    built-in element color for every other real element, "wheat" otherwise."""
    if symbol in ELEMENT_COLORS:
        return ELEMENT_COLORS[symbol]
    return _ELEMENT_NAMES.get(symbol, "wheat")


def channel_color(name: str, index: int) -> str:
    """Color for a named channel: element color when the name is an element
    symbol, else a palette rotation."""
    if name in ELEMENT_COLORS or (len(name) <= 2 and name.isalpha()):
        return atom_color(name)
    return CHANNEL_PALETTE[index % len(CHANNEL_PALETTE)]
