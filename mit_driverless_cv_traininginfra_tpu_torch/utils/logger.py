"""Logging and command-line helpers (the port's copy of the JAX package's
``utils/logger.py``).

:class:`Logger` tees stdout (a ``.log`` file) or stderr (a ``.error``
file) to a file, as the reference's ``Logger`` does;
:func:`write_score_file` is the sweep layer's metric channel;
:func:`add_bool_arg` is the reference's ``--x`` / ``--no_x`` switch pair.
"""

from __future__ import annotations

import os
import sys


class Logger(object):
    def __init__(self, File: str):
        Type = File.split(".")[-1]
        self.terminal = sys.stderr if Type == "error" else sys.stdout
        os.makedirs(os.path.dirname(File) or ".", exist_ok=True)
        # line-buffered: someone tailing the log sees each line as it comes
        self.log = open(File, "w", buffering=1)

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()


def add_bool_arg(parser, name: str, default: bool, help: str):
    """``--name`` / ``--no_name`` switches for one boolean ``name``."""
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--" + name, dest=name, action="store_true", help=help)
    group.add_argument("--no_" + name, dest=name, action="store_false",
                       help="Do not " + help)
    parser.set_defaults(**{name: default})


def write_score_file(path: str, value: float):
    """Write ``value`` as the whole text of ``path`` (the sweep layer reads
    a run's score there)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(str(value))
