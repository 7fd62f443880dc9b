"""Whether the figures can be drawn: matplotlib is optional in the port.

The machine with the card has no matplotlib. The entry points that draw a
figure compute every number without it, draw only where it is installed,
and otherwise record :data:`PLOTS_SKIPPED` where the figure's path would
stand.
"""

from __future__ import annotations

PLOTS_SKIPPED = "skipped: matplotlib not installed"


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True
