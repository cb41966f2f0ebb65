"""Logging configuration, the port's own copy of
``vtc_tpu/utils/logging_setup.py``.

The reference intends to load ``logger/logger_config.json`` but that file is
missing from its repo, so it always falls back to ``basicConfig`` with a
warning (``logger/logger.py:7-27``). Here the default dictConfig is bundled
inline (documented reference defect, not replicated).
"""

from __future__ import annotations

import logging
import logging.config
from pathlib import Path

DEFAULT_LOGGING_CONFIG = {
    "version": 1,
    "disable_existing_loggers": False,
    "formatters": {
        "simple": {"format": "%(message)s"},
        "datetime": {
            "format": "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
        },
    },
    "handlers": {
        "console": {
            "class": "logging.StreamHandler",
            "level": "DEBUG",
            "formatter": "simple",
            "stream": "ext://sys.stdout",
        },
        "info_file_handler": {
            "class": "logging.handlers.RotatingFileHandler",
            "level": "INFO",
            "formatter": "datetime",
            "filename": "info.log",
            "maxBytes": 10485760,
            "backupCount": 20,
            "encoding": "utf8",
        },
    },
    "root": {"level": "INFO", "handlers": ["console", "info_file_handler"]},
}


def setup_logging(save_dir, default_level=logging.INFO) -> None:
    """Configure python logging with a console + rotating-file handler pair,
    the setup ``logger/logger.py:7-27`` intended but could not load."""
    save_dir = Path(save_dir)
    config = {k: v for k, v in DEFAULT_LOGGING_CONFIG.items()}
    handlers = {k: dict(v) for k, v in config["handlers"].items()}
    for handler in handlers.values():
        if "filename" in handler:
            handler["filename"] = str(save_dir / handler["filename"])
    config = dict(config, handlers=handlers)
    logging.config.dictConfig(config)
    logging.getLogger().setLevel(default_level)
