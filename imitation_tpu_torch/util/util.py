"""Miscellaneous utilities: the port of ``imitation_tpu/util/util.py``."""

from __future__ import annotations

import datetime
import itertools
import os
import pathlib
import uuid
import warnings
from typing import Iterable, Iterator, List, Optional, Tuple, TypeVar, Union

import numpy as np
import torch

T = TypeVar("T")


def make_unique_timestamp() -> str:
    """A timestamp ``%Y%m%d_%H%M%S`` and six hex digits of a random uuid."""
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    return f"{timestamp}_{uuid.uuid4().hex[:6]}"


def oric(x: np.ndarray) -> np.ndarray:
    """Optimal rounding under integer constraints.

    Rounds each element so that the sum equals ``round(sum(x))`` while
    keeping the total rounding error least: floor everything, then add one
    to the entries with the largest fractional parts.
    """
    rounded = np.floor(x)
    shortfall = x - rounded
    deficit = int(np.round(np.sum(x) - np.sum(rounded)))
    indices = np.argsort(-shortfall)[:deficit]
    rounded[indices] += 1
    return rounded.astype(int)


def endless_iter(iterable: Iterable[T]) -> Iterator[T]:
    """Cycles through ``iterable`` for ever; raises if it is empty."""
    try:
        next(iter(iterable))
    except StopIteration:
        raise ValueError(f"iterable {iterable} had no elements to iterate over.")
    return itertools.chain.from_iterable(itertools.repeat(iterable))


def get_first_iter_element(iterable: Iterable[T]) -> Tuple[T, Iterable[T]]:
    """``(first element, an iterable of all the elements)``; an iterator is
    chained back together, anything else is returned as it is."""
    iterator = iter(iterable)
    try:
        first_element = next(iterator)
    except StopIteration:
        raise ValueError(f"iterable {iterable} had no elements to iterate over.")
    if iterator == iterable:
        return first_element, itertools.chain([first_element], iterator)
    return first_element, iterable


def split_in_half(x: int) -> Tuple[int, int]:
    """``x`` split in two, the first half rounded up."""
    half = x // 2
    return half + (x % 2), half


def parse_path(
    path: Union[str, bytes, os.PathLike],
    allow_relative: bool = True,
    base_directory: Optional[pathlib.Path] = None,
) -> pathlib.Path:
    """``path`` as a ``pathlib.Path``; a relative path is taken from
    ``base_directory`` (default the working directory), or refused when
    ``allow_relative`` is False."""
    if base_directory is not None and not allow_relative:
        raise ValueError("If `base_directory` is specified, then `allow_relative` must be True.")
    parsed_path = pathlib.Path(os.fsdecode(path) if isinstance(path, bytes) else path)
    if parsed_path.is_absolute():
        return parsed_path
    if allow_relative:
        return (base_directory if base_directory is not None else pathlib.Path.cwd()) / parsed_path
    raise ValueError(f"Path {str(parsed_path)} is not absolute")


def parse_optional_path(
    path: Optional[Union[str, bytes, os.PathLike]],
    allow_relative: bool = True,
    base_directory: Optional[pathlib.Path] = None,
) -> Optional[pathlib.Path]:
    """``parse_path``, passing None through."""
    if path is None:
        return None
    return parse_path(path, allow_relative, base_directory)


def make_seeds(rng: np.random.Generator, n: Optional[int] = None) -> Union[int, List[int]]:
    """``n`` seeds drawn from ``rng`` in ``[0, 2^31 - 1)`` (one int when
    ``n`` is None)."""
    seeds = rng.integers(0, (1 << 31) - 1, (n if n is not None else 1,)).tolist()
    return seeds[0] if n is None else seeds


def safe_to_numpy(obj, warn: bool = False) -> Optional[np.ndarray]:
    """``obj`` as a numpy array: a tensor is detached and copied to the
    host (with a warning if ``warn``, since the copy synchronizes the
    device); None stays None."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        if warn:
            warnings.warn("Converted a tensor to a numpy array; the copy to the host synchronizes the device.")
        return obj.detach().cpu().numpy()
    return np.asarray(obj)
