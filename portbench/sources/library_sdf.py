"""The seeded ligand library of ``library.py``, written to disk as one SDF V2000 file.

The records are ``library.generate``'s, in its order: the template ligand
rotated, jittered and cut, record ``all_h_record`` five hydrogens and record
``empty_record`` no atom.  Each atom line holds the coordinates to four
decimals (``%10.4f``, as ``library.py`` rounds them) and the symbol.  The
program reads the file; the reference takes the heavy atoms in memory
(``molecules``), so that neither side sees what the other parsed.
"""

from __future__ import annotations

from pathlib import Path

from portbench.harness import BENCH_DIR, load_module

_TAIL = "  0  0  0  0  0  0  0  0  0  0  0  0\n"


def _library():
    return load_module(BENCH_DIR / "sources" / "library.py")


def molecules(root, cfg, seed: int) -> list:
    """Each record's heavy atoms, as ``library.molecules`` gives them."""
    return _library().molecules(root, cfg, seed)


def write(root, cfg, seed: int, path: Path) -> list:
    """Write the library to ``path`` as SDF V2000; return ``molecules``."""
    lib = _library().generate(root, cfg, seed)
    names = list(lib.symbols) + ["H"]
    lines = [f"{x:10.4f}{y:10.4f}{z:10.4f} {names[s]:<3}{_TAIL}" for (x, y, z), s in zip(lib.xyz.tolist(),
                                                                                       lib.sym.tolist())]
    parts, start = [], 0
    for i, n in enumerate(lib.counts.tolist()):
        parts.append(f"lig{i}\n  portbench\n\n{n:3d}  0  0  0  0  0  0  0  0999 V2000\n")
        parts.extend(lines[start:start + n])
        parts.append("M  END\n$$$$\n")
        start += n
    Path(path).write_text("".join(parts))
    return molecules(root, cfg, seed)
