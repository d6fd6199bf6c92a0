"""A custom-image unit for ``chip_smoke.py``'s phase 9m (the control
plane): the port's ``TorchServer`` reporting, through Seldon's user-model
``metrics()`` hook, what kernel B1 did inside its own pod.

Deployed by a SeldonDeployment as ``local/chip_smoke_unit.B1ProbeServer:1``
(the local process store runs ``module.Class`` images as the unit's
class), it takes every ``TorchServer`` parameter. Once loaded it counts
B1's launches from zero and holds the kernel to its plain version on the
first, middle and last layer of every wave (``chip_smoke.KernelTap``, on
the pod's own inputs). Every answer's ``meta.metrics`` then carries, as
gauges: ``b1_launches``, ``b1_wave_legs`` (decode waves + prefill
waves), ``b1_layers``, ``b1_checked`` and the largest errors of the
checked launches ``b1_err_m`` / ``b1_err_l_rel`` / ``b1_err_acc``, and
the pod's card memory once ready, ``card_allocated_at_ready`` and
``card_reserved_at_ready`` (bytes). The serving path is TorchServer's
own; only the tap is added."""

from __future__ import annotations

from typing import Dict, List

from seldon_tpu_torch.servers.torchserver import TorchServer


class B1ProbeServer(TorchServer):
    _tap = None
    _ready_memory = None

    def load(self) -> None:
        super().load()
        if self._ready_memory is None and self.device.type == "cuda":
            import torch

            self._ready_memory = {
                "card_allocated_at_ready": torch.cuda.memory_allocated(),
                "card_reserved_at_ready": torch.cuda.memory_reserved()}
        if self._tap is None:
            import chip_smoke
            from seldon_tpu_torch.ops import ragged_paged_attention as rpa

            self._tap = chip_smoke.KernelTap(self.cfg.n_layers).__enter__()
            rpa.launches = 0  # count the served requests' launches only

    def metrics(self) -> List[Dict]:
        out = super().metrics()
        if self._tap is None:
            return out
        from seldon_tpu_torch.ops import ragged_paged_attention as rpa

        snap = self.engine.stats.snapshot()
        errs = list(self._tap.errs.values()) or [(0.0, 0.0, 0.0)]
        probe = {
            "b1_launches": rpa.launches,
            "b1_wave_legs": snap["decode_dispatches"] + snap["prefill_waves"],
            "b1_layers": self.cfg.n_layers,
            "b1_checked": sum(self._tap.checked.values()),
            "b1_err_m": max(e[0] for e in errs),
            "b1_err_l_rel": max(e[1] for e in errs),
            "b1_err_acc": max(e[2] for e in errs),
        }
        probe.update(self._ready_memory or {})
        return out + [{"type": "GAUGE", "key": k, "value": float(v)}
                      for k, v in probe.items()]
