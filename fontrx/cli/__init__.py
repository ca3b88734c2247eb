"""CLI layer: config/flag parsing + entry point.

Semantics of the reference's ``src/Config.zig`` (typed options derived
from a schema, long/short names, duplicate detection, error
accumulation) and ``src/main.zig`` (open font, build scene, run loop),
extended with raster-specific options (size, samples, output mode).
"""

from fontrx.cli.config import Config, ConfigError, parse_args  # noqa: F401
