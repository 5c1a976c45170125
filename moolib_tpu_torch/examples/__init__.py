"""The port's examples: the envs, the rollout bookkeeping they share
(:mod:`.common`), the elastic V-trace experiment (:mod:`.vtrace`), A2C on
CartPole (:mod:`.a2c`) and the remote-actors split (:mod:`.remote_actors`);
the counterpart of :mod:`moolib_tpu.examples`. Importing the package
imports none of them (Env workers import :mod:`.envs` alone)."""
