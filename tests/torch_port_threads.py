"""Torch's CPU threads in a test worker: imported by every
``test_torch_*.py`` (through ``torch_port_fixtures`` or directly; no JAX,
so the card's test files import it too).

pytest-xdist sets ``PYTEST_XDIST_WORKER_COUNT`` in each worker. Each torch
would otherwise start one OpenMP thread per core, and the workers' threads
together oversubscribe the cores many times over: the port's CPU tests then
run 20x slower or more. A worker takes its share of the cores; a run
without workers keeps torch's default.
"""

import os

import torch

WORKERS = os.environ.get('PYTEST_XDIST_WORKER_COUNT')
if WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(WORKERS)))
