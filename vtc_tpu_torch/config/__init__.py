"""The experiment config: JSONC file, ``;``-path overrides, run layout."""

from .parse_config import ConfigParser, CustomArgs

__all__ = ["ConfigParser", "CustomArgs"]
