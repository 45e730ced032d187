"""Channel getters: map atoms/bonds to type indices or feature vectors.

Mirrors the reference getter hierarchy
(reference molvoxel/etc/rdkit/base.py:7-52, getter.py:14-46) but is
chemistry-toolkit agnostic: getters duck-type their input, accepting either
plain values (element symbol strings, bond-type-name strings from
data.parsers.SimpleMolecule) or RDKit Atom/Bond objects when RDKit is
installed.  The reference works exclusively on RDKit objects.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any


class ChannelGetter:
    def __init__(self, channels: Sequence[str]):
        self.channels = list(channels)
        self.num_channels = len(self.channels)


class FeatureGetter(ChannelGetter):
    """Wraps a user callable input -> feature vector (reference base.py:13-21)."""

    CHANNEL_TYPE = "FEATURE"

    def __init__(self, function: Callable[[Any], Sequence[float]], channels: Sequence[str]):
        super().__init__(channels)
        self.feature_getter = function

    def get_feature(self, input: Any, **kwargs):
        return self.feature_getter(input, **kwargs)


class TypeGetter(ChannelGetter):
    """Maps a key to a type index; optional catch-all "Unknown" channel
    (reference base.py:24-52)."""

    CHANNEL_TYPE = "TYPE"

    def __init__(self, types: Sequence[Any], channels: Sequence[str], unknown: bool = False):
        channels = list(channels)
        if unknown:
            channels.append("Unknown")
        super().__init__(channels)
        self.unknown = unknown
        self._type_dic = {typ: idx for idx, typ in enumerate(types)}
        self.feature_list = [
            [1.0 if j == i else 0.0 for j in range(self.num_channels)] for i in range(self.num_channels)
        ]

    def _key(self, input: Any) -> Any:
        return input

    def get_type(self, input: Any, **kwargs) -> int:
        key = self._key(input)
        if self.unknown:
            return self._type_dic.get(key, self.num_channels - 1)
        return self._type_dic[key]

    def get_feature(self, input: Any, **kwargs):
        return self.feature_list[self.get_type(input, **kwargs)]

    def to_feature_getter(self) -> FeatureGetter:
        return FeatureGetter(self.get_feature, self.channels)


""" ATOM """

AtomChannelGetter = ChannelGetter


class AtomFeatureGetter(FeatureGetter): ...


class AtomTypeGetter(TypeGetter):
    """Type by element symbol (reference getter.py:14-21).

    Accepts a symbol string or any object with ``GetSymbol()`` (RDKit Atom).
    """

    def __init__(self, symbols: Sequence[str], symbol_names: Sequence[str] | None = None, unknown: bool = False):
        if symbol_names is None:
            symbol_names = list(symbols)
        super().__init__(list(symbols), list(symbol_names), unknown)

    def _key(self, input: Any) -> str:
        if isinstance(input, str):
            return input
        return input.GetSymbol()


""" BOND """

BondChannelGetter = ChannelGetter


class BondFeatureGetter(FeatureGetter): ...


class BondTypeGetter(TypeGetter):
    """Type by bond order name (reference getter.py:31-46).

    Accepts a bond-type name string ("SINGLE", "DOUBLE", "TRIPLE",
    "AROMATIC", ... — what data.parsers emits), an RDKit BondType enum, or an
    RDKit Bond object.
    """

    def __init__(
        self, bondtypes: Sequence[Any], bondtype_names: Sequence[str] | None = None, unknown: bool = False
    ):
        keys = [self._normalize(bt) for bt in bondtypes]
        if bondtype_names is None:
            bondtype_names = keys
        super().__init__(keys, list(bondtype_names), unknown)

    @staticmethod
    def _normalize(bt: Any) -> str:
        return bt if isinstance(bt, str) else str(bt)

    def _key(self, input: Any) -> str:
        if isinstance(input, str):
            return input
        if hasattr(input, "GetBondType"):
            return str(input.GetBondType())
        return str(input)

    @classmethod
    def default(cls) -> "BondTypeGetter":
        """SINGLE/DOUBLE/TRIPLE/AROMATIC, as the reference default (getter.py:42-46)."""
        return cls(
            ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC"],
            ["SingleBond", "DoubleBond", "TripleBond", "AromaticBond"],
        )
