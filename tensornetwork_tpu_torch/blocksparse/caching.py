"""Opt-in memoization of block-lookup metadata
(reference ``block_sparse/caching.py:22-96``).

A copy of :mod:`tensornetwork_tpu.blocksparse.caching`: host-side Python,
kept in the port so that it imports nothing of the JAX package."""
from __future__ import annotations


class Cacher:
    def __init__(self):
        self.cache = {}
        self.do_caching = False

    def set_status(self, value: bool):
        self.do_caching = bool(value)

    def clear_cache(self):
        self.cache = {}

    @property
    def is_empty(self) -> bool:
        return len(self.cache) == 0


_INSTANCE = Cacher()


def get_cacher() -> Cacher:
    """(reference ``caching.py:49``)"""
    return _INSTANCE


def enable_caching():
    _INSTANCE.set_status(True)


def disable_caching():
    _INSTANCE.set_status(False)


def clear_cache():
    _INSTANCE.clear_cache()
