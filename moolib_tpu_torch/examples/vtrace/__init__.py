"""Elastic IMPALA/V-trace experiment package; the counterpart of
:mod:`moolib_tpu.examples.vtrace`.

Lazy re-exports: importing the package must not import the experiment
module, so ``python -m moolib_tpu_torch.examples.vtrace.experiment`` runs
it exactly once (runpy executes the module fresh after importing the
package).
"""


def __getattr__(name):
    if name in ("VtraceConfig", "train"):
        from . import experiment

        return getattr(experiment, name)
    raise AttributeError(name)
