"""The benchmark's plain reference: plain torch and numpy, no part of the
program under test, no jax. ``portbench.guard.reference_imports`` holds
this package to that on every run."""
