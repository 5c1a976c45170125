"""Mean host ms a window step in StepScope's ``fwd_bwd`` phase (the
program's span around ``make_grad_step``'s call): its dispatch, and any
wait for room in the card's launch queue."""


def read(r):
    return r.phase_ms.get("fwd_bwd")
