"""Command-line helpers (the port's copy of what its CLIs need from the
JAX package's ``utils/logger.py``)."""

from __future__ import annotations


def add_bool_arg(parser, name: str, default: bool, help: str):
    """``--name`` / ``--no_name`` switches for one boolean ``name``."""
    group = parser.add_mutually_exclusive_group(required=False)
    group.add_argument("--" + name, dest=name, action="store_true", help=help)
    group.add_argument("--no_" + name, dest=name, action="store_false",
                       help="Do not " + help)
    parser.set_defaults(**{name: default})
