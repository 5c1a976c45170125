"""Mean host ms a window step in StepScope's ``optimizer`` phase (the
program's span around ``make_apply_step``'s call)."""


def read(r):
    return r.phase_ms.get("optimizer")
