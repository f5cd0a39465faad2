"""Port-only additions to the model config: DeepSeek-V3's router and the
share of the routed experts that one chip of an expert-parallel layer
holds.

``models/config.py`` is a verbatim copy of the reference's, which has
neither, so they live here as subclasses: a :class:`GroupRoutedMoE` is a
``MoEConfig`` whose ``num_experts`` counts the experts held here (what
the expert stacks hold), while the router scores ``routed_experts``; a
:class:`HeldExpertsModel` is a ``ModelConfig`` whose parameter counts
know that the router is wider than the stacks.  ``expert_groups`` are
groups of experts (DeepSeek's ``n_group``), not the routing groups of the
token stream that ``moe_groups`` names elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig, MoEConfig, \
    iter_param_shapes


@dataclass(frozen=True)
class GroupRoutedMoE(MoEConfig):
    """Sigmoid, group-limited, bias-corrected routing (DeepSeek-V3's
    ``noaux_tc``) over ``routed_experts`` experts in ``expert_groups``
    equal groups, of which the best ``top_expert_groups`` are searched for
    each token's ``top_k``; gates renormalised, then scaled by
    ``routed_scale``.  The layer holds and computes the ``num_experts``
    experts ``[held_first, held_first + num_experts)`` of them."""
    routed_experts: int = 0
    expert_groups: int = 1
    top_expert_groups: int = 1
    routed_scale: float = 1.0
    held_first: int = 0

    def __post_init__(self):
        R, G = self.routed_experts, self.expert_groups
        if R % G or not 0 < self.top_expert_groups <= G:
            raise ValueError(f"{R} experts in {G} groups, "
                             f"{self.top_expert_groups} kept")
        if self.top_k > self.top_expert_groups * (R // G):
            raise ValueError(f"top {self.top_k} of {self.top_expert_groups} "
                             f"groups of {R // G}")
        if not 0 <= self.held_first <= R - self.num_experts:
            raise ValueError(f"experts [{self.held_first}, "
                             f"{self.held_first + self.num_experts}) held of "
                             f"{R}")


def param_shapes(cfg: ModelConfig, with_active: bool = False) -> list:
    """``config.iter_param_shapes`` with each :class:`GroupRoutedMoE`
    layer's router ``routed_experts`` wide, its correction bias after it
    (``router_bias``), and an expert stack's active share ``top_k /
    routed_experts``: a token's expected use of the experts held here."""
    mo = cfg.moe
    out = []
    for name, n, active in iter_param_shapes(cfg, with_active=True):
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mo, GroupRoutedMoE) and ".moe." in name:
            if leaf == "router":
                R = mo.routed_experts
                out += [(name, cfg.d_model * R, cfg.d_model * R),
                        (name + "_bias", R, R)]
                continue
            if leaf in ("w_gate", "w_up", "w_down"):
                active = int(n * mo.top_k / mo.routed_experts)
        out.append((name, n, active))
    return out if with_active else [(name, n) for name, n, _ in out]


@dataclass(frozen=True)
class HeldExpertsModel(ModelConfig):
    """A ModelConfig whose MoE layers may be :class:`GroupRoutedMoE`
    shares; its counts follow :func:`param_shapes`."""

    def param_count(self) -> int:
        return sum(n for _, n in param_shapes(self))

    def active_param_count(self) -> int:
        return sum(a for _, _, a in param_shapes(self, with_active=True))


__all__ = ["GroupRoutedMoE", "HeldExpertsModel", "param_shapes"]
