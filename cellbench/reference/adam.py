"""Adam (Kingma and Ba 2015) after clipping the gradients by their
global norm, as optax chains ``clip_by_global_norm(max_norm)`` and
``adam(lr, b1, b2, eps, eps_root)``: every gradient is scaled by
max_norm / |g| when |g| >= max_norm; mu and nu start at 0; the update is
-lr * mu_hat / (sqrt(nu_hat + eps_root) + eps). ``state_dtype`` holds mu
and nu (f32, or bf16 in a control); the parameters stay f32."""

import torch


class ClippedAdam:
    def __init__(self, params: dict, opt: dict,
                 state_dtype: torch.dtype = torch.float32):
        self.params = params
        self.opt = opt
        self.t = 0
        self.mu = {k: torch.zeros_like(v, dtype=state_dtype)
                   for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v, dtype=state_dtype)
                   for k, v in params.items()}

    @torch.no_grad()
    def clip(self, grads: dict):
        """(the clipped gradients, the factor they were scaled by)."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if float(norm) < self.opt["max_norm"]:
            return dict(grads), 1.0
        factor = self.opt["max_norm"] / float(norm)
        return {k: g / norm * self.opt["max_norm"]
                for k, g in grads.items()}, factor

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        """Apply already clipped ``grads`` in place."""
        o = self.opt
        self.t += 1
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
            self.nu[k].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            mu_hat = self.mu[k].float() / (1 - o["b1"] ** self.t)
            nu_hat = self.nu[k].float() / (1 - o["b2"] ** self.t)
            p.sub_(o["lr"] * mu_hat / (torch.sqrt(nu_hat + o["eps_root"])
                                       + o["eps"]))
