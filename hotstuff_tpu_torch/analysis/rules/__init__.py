"""The rule registry: ``ALL_RULES`` is what the CLI and the gate run."""

from .blocking import NoBlockingInAsync
from .clock_discipline import ClockDiscipline
from .env_knobs import EnvKnobRegistry
from .guarded_by import GuardedBy
from .taxonomy_rule import TaxonomyRegistry
from .wire_bounds import WireDecoderBounds

ALL_RULES = (
    NoBlockingInAsync(),
    WireDecoderBounds(),
    TaxonomyRegistry(),
    EnvKnobRegistry(),
    GuardedBy(),
    ClockDiscipline(),
)

__all__ = [
    "ALL_RULES",
    "NoBlockingInAsync",
    "WireDecoderBounds",
    "TaxonomyRegistry",
    "EnvKnobRegistry",
    "GuardedBy",
    "ClockDiscipline",
]
