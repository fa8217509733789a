"""Faults planted in the program underneath a whole run, for the tests
and for ``calibrate``: each patches the port's classes inside a ``with``
block and undoes it on leaving.  With ``after`` the first ``after``
train steps run sound (the checked first steps and the warm-up), so that
the fault is the window's alone.

- ``state_unchanged``: every optimizer's step leaves its leaves as they
  were;
- ``optimizer_left_out.<model|cluster|linear>``: one optimizer's step
  does;
- ``half_batch``: the step computes on the first half of its batch, the
  mean taken over it;
- ``answer_altered``: every pixel of each served cluster map moved to a
  neighbouring class;
- ``half_requests``: the predictor computes the first half of each
  request and returns zeros for the rest.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

TRAIN = ("state_unchanged", "optimizer_left_out.model", "optimizer_left_out.cluster",
         "optimizer_left_out.linear", "half_batch")
SEGMENT = ("answer_altered", "half_requests")

#: a parameter name of each optimizer's, as ``Optimizer`` names them
_MARK = {"model": "pq.codebook", "cluster": "clusters", "linear": "linear.weight"}


@contextlib.contextmanager
def planted(name: str, after: int = 0) -> Iterator[None]:
    import torch
    from equss_tpu_torch import serve
    from equss_tpu_torch.train import optim
    from equss_tpu_torch.train.trainer import Trainer

    saved = []
    begun = [0]

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    def active() -> bool:
        return begun[0] > after

    train_step = Trainer.train_step

    def counted(self, batch):
        begun[0] += 1
        return train_step(self, batch)

    patch(Trainer, "train_step", counted)
    step = optim.Optimizer.step
    if name == "state_unchanged" or name.startswith("optimizer_left_out."):
        which = name.split(".", 1)[1] if "." in name else None

        def maybe(self, norm=None):
            names = {n for n, _ in self._named}
            if active() and (which is None or _MARK[which] in names):
                return None
            return step(self, norm)

        patch(optim.Optimizer, "step", maybe)
    elif name == "half_batch":
        batch = Trainer._batch

        def halved(self, b, *a, **k):
            out = batch(self, b, *a, **k)
            if not active():
                return out
            h = out["img"].shape[0] // 2
            return {key: v[:h] if key != "stego_perms" else v[:, :h] % h
                    for key, v in out.items()}

        patch(Trainer, "_batch", halved)
    elif name in SEGMENT:
        forward = serve.Predictor.forward

        def broken(self, img):
            if name == "half_requests":
                h = img.shape[0] // 2
                out = forward(self, img[:h])
                return {k: torch.cat([v, torch.zeros_like(v)]) for k, v in out.items()}
            out = forward(self, img)
            return {k: torch.where(v > 0, v - 1, v + 1) if k == "cluster_preds" else v
                    for k, v in out.items()}

        patch(serve.Predictor, "forward", broken)
    else:
        raise ValueError(f"unknown fault {name}")
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
