"""Second-stage package imports (port of ``paddle_tpu/_late_imports.py``):
the subpackages that build on the core, and the names the top level
re-exports from them. The JAX package imports each under ``try``; here every
one is part of the port, so a failing import fails the package's import."""
from . import (amp, distributed, framework, hapi, incubate, inference, io,
               jit, metric, models, nn, observability, optimizer, profiler,
               reliability, serving, static, vision)
from .framework.io import load, save
from .hapi import Model, flops, summary

__all__ = ["Model", "amp", "distributed", "flops", "framework", "hapi",
           "incubate", "inference", "io", "jit", "load", "metric", "models",
           "nn", "observability", "optimizer", "profiler", "reliability",
           "save", "serving", "static", "summary", "vision"]
