"""Logging set-up: the format and level of the JAX package's CLIs."""

from __future__ import annotations

import logging


def setup_logging(level: int = logging.INFO) -> None:
    logging.basicConfig(level=level, format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
                        datefmt="%H:%M:%S")
