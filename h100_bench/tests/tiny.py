"""Tiny versions of the cells for the CPU tests: the cells' own
configurations, mixes and limits at 64x64 and a few rows."""

import torch

from h100_bench import run, spec

SIZES = {"cls_train": {"batch": 4, "pool": 14},
         "cls_forensics": {"batch": 4, "pool": 14},
         "cls_serve": {"batch": 4, "pool": 14},
         "seg_train": {"batch": 2, "pool": 8}}
SEED = 2 ** 31 + 4242


def cell(name, size=64):
    c = spec.Cell(name)
    c.config = dict(c.config, image_size=size)
    c.traffic = dict(c.traffic, **SIZES[name])
    return c


def run_tiny(name, program, seconds=0.3, seed=SEED):
    """(result line, Result) of one CPU run of the tiny cell."""
    c = cell(name)
    res, _ = run.run_cell(c, seed, seconds, False, torch.device("cpu"),
                          program)
    return run.result_line(c, res, False, torch.device("cpu"), 1), res
