"""Logger factory.

Keeps the reference's operational contract: LOG_LEVEL env var with a
whitelist, one-time root configuration, the exact
``[%(levelname)s] %(asctime)s |%(name)s| %(message)s`` line format, and noise
suppression for chatty third-party libraries.
"""

from __future__ import annotations

import logging
import os

_LINE_FORMAT = "[%(levelname)s] %(asctime)s |%(name)s| %(message)s"
_ALLOWED_LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR")

# Libraries whose INFO logs drown ours.
_NOISY_LOGGERS = (
    "pymongo",
    "pymongo.topology",
    "confluent_kafka",
    "uvicorn",
    "uvicorn.access",
    "asyncio",
)


def get_logger(name: str) -> logging.Logger:
    """Return a configured logger for a module (usually ``__name__``).

    Root configuration happens once, on first call, honoring ``LOG_LEVEL``.
    """
    level = os.getenv("LOG_LEVEL", "INFO").upper()
    if level not in _ALLOWED_LEVELS:
        level = "INFO"

    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=getattr(logging, level), format=_LINE_FORMAT)
        for noisy in _NOISY_LOGGERS:
            logging.getLogger(noisy).setLevel(logging.WARNING)

    return logging.getLogger(name)
