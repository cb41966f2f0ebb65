"""Config / flag system, the port's own copy of
``vtc_tpu/config/parse_config.py:37-261``.

Behavior-compatible with the reference's ``utils/parse_config.py:13-187``
(the config surface is part of the experiment contract):

* JSONC config files with sections name/batch_size/arch/dataset/optimizer/
  loss/metrics/lr_scheduler/trainer.
* CLI overrides declared as ``CustomArgs(flags, type, target)`` tuples where
  ``target`` is a ``;``-separated path into the config tree
  (``utils/parse_config.py:162-187``).
* Run directories ``save_dir/models/<name>/<NNN_MonDD_HH:MM>/`` carrying a
  monotonically increasing sequence number plus a timestamp
  (``utils/parse_config.py:33-50``), with the merged config re-serialized
  into the run dir as ``config.json``.
* ``-r/--resume`` re-reads the run's saved ``config.json``; passing ``-c``
  alongside ``-r`` overlays the new file for fine-tuning
  (``utils/parse_config.py:77-89``).
* Reflective construction ``init_obj`` (``utils/parse_config.py:97-112``).

Under a process group (``torchrun``) rank 0 alone picks the run directory,
broadcasts its name, creates it and writes ``config.json`` and the log
files; the other ranks create nothing and log warnings to the console with
their rank. A ``multihost`` config made before the group exists defers the
directory to ``finalize_run_dir``, as ``vtc_tpu``'s does
(``:73-157``). ``-d/--device`` is the JAX package's: a count of mesh
devices (or the reference's id list, "0,1"), written to ``n_devices``
unless ``--n_devices`` is given.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import NamedTuple

import torch.distributed as dist

from ..utils import read_json, setup_logging, write_json
from ..utils.util import barrier, broadcast_object, is_main, rank


class CustomArgs(NamedTuple):
    """One CLI override: argparse flags, value type, ``;``-path into the config."""

    flags: list
    type: type
    target: str


_RUN_DIR_RE = re.compile(r"(\d+)_[A-Za-z]{3}\d{2}_\d{2}:\d{2}\Z")
_LOG_LEVELS = (logging.WARNING, logging.INFO, logging.DEBUG)


def _next_run_id(exp_dir: Path) -> str:
    """``NNN_MonDD_HH:MM`` — sequence number continues from existing runs."""
    from datetime import datetime

    last = 0
    if exp_dir.is_dir():
        for child in exp_dir.iterdir():
            m = _RUN_DIR_RE.match(child.name)
            if m:
                last = max(last, int(m.group(1)))
    return f"{last + 1:03d}_{datetime.now():%b%d_%H:%M}"


def _override(cfg: dict, path: str, value) -> None:
    """Assign ``value`` at the ``;``-separated ``path`` inside ``cfg``."""
    node = cfg
    *parents, leaf = path.split(";")
    for key in parents:
        node = node[key]
    node[leaf] = value


class ConfigParser:
    """Parsed experiment config + run directory + reflective construction."""

    def __init__(self, config, resume=None, modification=None, run_id=None):
        if modification:
            for path, value in modification.items():
                if value is not None:
                    _override(config, path, value)
        self._config = config
        self.resume = resume
        self.log_levels = dict(enumerate(_LOG_LEVELS))
        self._run_dir = None
        if bool(config.get("multihost")) and run_id is None and not dist.is_initialized():
            # each process of a multihost run picking its own wall-clock run
            # id races the mkdir or splits the run over two directories: the
            # CLI calls finalize_run_dir() once the group exists
            return
        self.finalize_run_dir(run_id)

    def finalize_run_dir(self, run_id=None) -> Path:
        """Create the run directory: rank 0 picks the next run id and
        broadcasts it, and only rank 0 creates the directory and writes
        ``config.json`` and the log files; a barrier lets no rank go on
        before it exists. One process: the same without the collectives. A
        no-op once the directory is set."""
        if self._run_dir is not None:
            return self._run_dir
        exp_dir = Path(self._config["trainer"]["save_dir"]) / "models" / self._config["name"]
        main = is_main()
        if run_id is None:
            run_id = broadcast_object(_next_run_id(exp_dir) if main else None)
        run_dir = exp_dir / run_id
        if main:
            # an explicit empty run_id reuses exp_dir itself (no fresh-dir guard)
            run_dir.mkdir(parents=True, exist_ok=(run_id == ""))
            write_json(self._config, run_dir / "config.json")
            setup_logging(run_dir)
        else:
            logging.basicConfig(
                level=logging.WARNING,
                format=f"[rank {rank()}] %(levelname)s %(name)s: %(message)s")
        barrier()
        self._run_dir = run_dir
        return run_dir

    @classmethod
    def from_args(cls, args, options=(), argv=None):
        """Build from an argparse parser (the train/eval entry points) and
        ``argv`` (default: the process's arguments)."""
        for opt in options:
            args.add_argument(*opt.flags, default=None, type=opt.type)
        parsed = args if isinstance(args, tuple) else args.parse_args(argv)

        resume = getattr(parsed, "resume", None)
        explicit_cfg = getattr(parsed, "config", None)
        if resume is not None:
            resume = Path(resume)
            config = read_json(resume.parent / "config.json")
            # multihost is a property of one launch's topology, not of the
            # experiment: a resumed run does not inherit it
            config.pop("multihost", None)
            if explicit_cfg:  # fine-tuning: overlay the new config file
                config.update(read_json(explicit_cfg))
        else:
            if explicit_cfg is None:
                raise ValueError(
                    "Configuration file needs to be specified. "
                    "Add '-c config.jsonc', for example."
                )
            config = read_json(explicit_cfg)

        parsed_vars = vars(parsed)
        modification = {}
        for opt in options:
            long_flags = [f for f in opt.flags if f.startswith("--")]
            dest = (long_flags[0] if long_flags else opt.flags[0]).lstrip("-").replace("-", "_")
            modification[opt.target] = parsed_vars[dest]
        device = parsed_vars.get("device")
        if device is not None and modification.get("n_devices") is None:
            n = len(device.split(",")) if "," in str(device) else int(device)
            modification["n_devices"] = n
        return cls(config, resume, modification)

    # -- reflective construction ------------------------------------------

    def _resolve(self, name: str, kwargs: dict):
        section = self[name]
        call_args = dict(section["args"])
        clashes = set(kwargs) & set(call_args)
        if clashes:
            raise ValueError(
                f"Overwriting kwargs given in config file is not allowed: {clashes}"
            )
        call_args.update(kwargs)
        return section["type"], call_args

    def init_obj(self, name, module, *args, **kwargs):
        """``config.init_obj('arch', models)`` == ``models.<type>(**args)``."""
        type_name, call_args = self._resolve(name, kwargs)
        return getattr(module, type_name)(*args, **call_args)

    # -- dict-like access ---------------------------------------------------

    def __getitem__(self, name):
        return self._config[name]

    def get(self, name, default=None):
        return self._config.get(name, default)

    def get_logger(self, name, verbosity=2):
        if verbosity not in self.log_levels:
            raise ValueError(
                f"verbosity option {verbosity} is invalid. "
                f"Valid options are {list(self.log_levels)}."
            )
        logger = logging.getLogger(name)
        # only rank 0 logs below a warning
        logger.setLevel(self.log_levels[verbosity] if is_main() else logging.WARNING)
        return logger

    @property
    def config(self):
        return self._config

    @property
    def save_dir(self) -> Path:
        if self._run_dir is None:
            raise RuntimeError("run dir not finalized: a --multihost config defers it until "
                               "its process group exists; call finalize_run_dir() first "
                               "(the CLIs do)")
        return self._run_dir

    @property
    def log_dir(self) -> Path:
        return self.save_dir
