"""Friendly CLI error handling (the port's own copy of
paligemma_tpu/cli/errors.py).

The reference CLIs die with raw tracebacks on every user mistake (missing
file, wrong flag combination). ``user_errors()`` wraps a CLI main body:
*predictable* user-input failures exit with a one-line actionable message
(exit code 2, argparse convention), while genuine bugs still raise with a
full traceback — blanket except-everything would hide real defects.
"""

from __future__ import annotations

import contextlib
import sys


class CliError(Exception):
    """Raise inside a CLI for a user-facing error with a clean message."""


@contextlib.contextmanager
def user_errors():
    try:
        yield
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)
    except FileNotFoundError as e:
        name = getattr(e, "filename", None) or str(e)
        print(
            f"error: file not found: {name}\n"
            "  check --model_path / --image_file_path / --train_jsonl "
            "point at existing files",
            file=sys.stderr,
        )
        sys.exit(2)
    except (OSError, ValueError) as e:
        # unreadable image, malformed checkpoint/json, bad flag combination
        print(f"error: {e}", file=sys.stderr)
        sys.exit(2)


def require(cond: bool, message: str) -> None:
    if not cond:
        raise CliError(message)
