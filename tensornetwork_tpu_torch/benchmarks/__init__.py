"""Probes of the card, counterparts of the repo's ``benchmarks/`` scripts."""
