"""Twins of the benchmarks of ``benchmarks/`` that need JAX there (see
``run.py``); the framework-neutral ones run from ``benchmarks/`` as they are."""
