"""Shared utilities: scoped logging, fixed-point numbers, binary readers,
phase timer.  The analog of the reference's ``src/helpers.zig``."""

from fontrx.utils.log import get_logger  # noqa: F401
from fontrx.utils.fixed_point import FixedPoint, F2D14, F16D16  # noqa: F401
from fontrx.utils.reader import BigEndianReader  # noqa: F401
from fontrx.utils.timer import PhaseTimer  # noqa: F401
