"""The port's examples: the envs, the rollout bookkeeping they share
(:mod:`.common`) and the elastic V-trace experiment (:mod:`.vtrace`); the
counterpart of :mod:`moolib_tpu.examples`. Importing the package imports
none of them (Env workers import :mod:`.envs` alone)."""
