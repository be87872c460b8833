"""Numeric environment knobs, read as the reference reads them
(``skypilot_tpu/utils/common_utils.py`` ``env_float`` / ``env_int`` /
``env_optional_float``): an unset, empty or unparseable value gives the
default, so a mistyped tuning variable degrades to the default and
never stops the process."""
import os
from typing import Optional


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v else default
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v else default
    except ValueError:
        return default


def env_optional_float(name: str) -> Optional[float]:
    """A float knob with no default: unset, empty or unparseable is None
    (the /healthz staleness bound: absent means no bound)."""
    v = os.environ.get(name)
    try:
        return float(v) if v else None
    except ValueError:
        return None
