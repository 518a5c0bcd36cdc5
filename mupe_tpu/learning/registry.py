"""Algorithm registry: config-driven policy construction.

Counterpart of the reference's algo dispatch
(scripts/train.py:176-186 — ``algos[cfg.algo.name.lower()]`` — and the
``ALGOS`` dict in omni_drones/learning/__init__.py:20-40).  Each factory
takes the (already-built) env plus the ``algo.*`` CLI override dict and
returns a ready policy whose ``act``/``train_op``/``init`` the rollout
machinery drives.

Obs-layout requirements per algo (what the env must provide):
  mappo        any (flat or entity-dict obs; TP-net if env provides_tp)
  ppo          flat obs, or dict with "intrinsics" when priv branches on
  ppo_adapt    dict with "observation" + "intrinsics" + "observation_h"
               (Hover with env.dr_* ranges and env.obs_history_len > 0)
  ppo_rnn      flat obs (recurrent: hidden state threaded by the rollout)
  ppo_tconv    dict with "observation_h" (env.obs_history_len > 0)
  ppo_sdf      dict with a point-cloud "sdf" group (PointNet encoder)
  transformer  entity-dict obs (token per entity group)
  ppo_vision   dict with a "depth" frame [.., H, W, C] + flat branches
               (Hover with env.obs_depth=true; MixedObsEncoder)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from ..utils.config import apply_overrides
from .mappo import MAPPOCfg, MAPPOPolicy

ALGOS: Dict[str, Callable] = {}


def register_algo(name: str):
    def deco(fn):
        ALGOS[name] = fn
        return fn

    return deco


def _mk_cfg(cfg_cls, env, overrides: Dict[str, Any]):
    """Build an algo cfg, threading env-provided TP-net settings first so
    CLI overrides still win (reference cfg/algo/mappo.yaml:33-36)."""
    cfg = cfg_cls()
    env_cfg = env.cfg
    if getattr(env, "provides_tp", False) and hasattr(cfg, "use_tp_net"):
        cfg = dataclasses.replace(
            cfg,
            use_tp_net=env_cfg.use_tp_net,
            future_prediction_step=env_cfg.future_prediction_step,
            window_step=env_cfg.window_step,
        )
    return apply_overrides(cfg, overrides or {})


def _obs_is_dict(env) -> bool:
    if getattr(env, "provides_tp", False):
        return True
    return bool(getattr(env.cfg, "obs_is_dict", False))


@register_algo("mappo")
def _make_mappo(env, overrides):
    cfg = _mk_cfg(MAPPOCfg, env, overrides)
    is_multi = getattr(env, "provides_tp", False)
    return MAPPOPolicy(
        cfg,
        n_agents=env.num_agents,
        action_dim=env.action_dim,
        obs_is_dict=_obs_is_dict(env),
        tp_input_dim=env.cfg.tp_input_dim if is_multi else None,
    )


# The PPO family is built on flax linen (learning/modules/linen.py), so
# each factory below imports its algorithm only when it is chosen.


@register_algo("ppo")
def _make_ppo(env, overrides):
    from .ppo import PPOCfg, PPOPolicy

    cfg = _mk_cfg(PPOCfg, env, overrides)
    return PPOPolicy(
        cfg,
        n_agents=env.num_agents,
        action_dim=env.action_dim,
        obs_is_dict=_obs_is_dict(env),
    )


@register_algo("ppo_adapt")
def _make_ppo_adapt(env, overrides):
    from .ppo.ppo_adapt import PPOAdaptCfg, PPOAdaptivePolicy

    cfg = _mk_cfg(PPOAdaptCfg, env, overrides)
    if not _obs_is_dict(env):
        raise ValueError(
            "ppo_adapt needs dict observations with 'intrinsics' and "
            "'observation_h' — enable env.dr_* ranges and "
            "env.obs_history_len (see envs/hover.py HoverCfg)"
        )
    return PPOAdaptivePolicy(
        cfg, n_agents=env.num_agents, action_dim=env.action_dim
    )


@register_algo("ppo_rnn")
def _make_ppo_rnn(env, overrides):
    from .ppo.ppo_rnn import PPORNNCfg, PPORNNPolicy

    cfg = _mk_cfg(PPORNNCfg, env, overrides)
    return PPORNNPolicy(
        cfg, n_agents=env.num_agents, action_dim=env.action_dim
    )


@register_algo("ppo_tconv")
def _make_ppo_tconv(env, overrides):
    from .ppo import PPOTConvPolicy

    cfg = _mk_cfg(MAPPOCfg, env, overrides)
    cfg = dataclasses.replace(cfg, use_tp_net=False)
    return PPOTConvPolicy(
        cfg,
        n_agents=env.num_agents,
        action_dim=env.action_dim,
        obs_is_dict=_obs_is_dict(env),
    )


@register_algo("ppo_sdf")
def _make_ppo_sdf(env, overrides):
    from .ppo import PPOSDFNavPolicy

    cfg = _mk_cfg(MAPPOCfg, env, overrides)
    cfg = dataclasses.replace(cfg, use_tp_net=False)
    return PPOSDFNavPolicy(
        cfg, n_agents=env.num_agents, action_dim=env.action_dim
    )


@register_algo("ppo_vision")
def _make_ppo_vision(env, overrides):
    """Vision PPO: MixedObsEncoder (conv depth branch + MLP state branch)
    actor/critic over envs emitting a "depth" observation — the end-to-end
    consumer of sensors/depth.py (reference MixedEncoder networks.py:322-368;
    vision is viz-only there)."""
    from .modules.linen import VisionActor, VisionCritic

    overrides = dict(overrides or {})
    # backbone choice: "conv" (default) or "mobilenet_v3_small"/"_large"
    # (the reference's torchvision backbone, networks.py:371-428)
    vision_encoder = overrides.pop("vision_encoder", "conv")
    cfg = _mk_cfg(MAPPOCfg, env, overrides)
    cfg = dataclasses.replace(cfg, use_tp_net=False, use_fused_encoder=False)
    if not _obs_is_dict(env):
        raise ValueError(
            "ppo_vision needs dict observations with a 'depth' frame — "
            "set env.obs_depth=true (see envs/hover.py HoverCfg)"
        )
    return MAPPOPolicy(
        cfg,
        n_agents=env.num_agents,
        action_dim=env.action_dim,
        obs_is_dict=True,
        actor_module=VisionActor(
            action_dim=env.action_dim, vision_encoder=vision_encoder
        ),
        critic_module=VisionCritic(vision_encoder=vision_encoder),
    )


@register_algo("transformer")
def _make_transformer(env, overrides):
    from .ppo import TransformerPPOPolicy

    cfg = _mk_cfg(MAPPOCfg, env, overrides)
    cfg = dataclasses.replace(cfg, use_tp_net=False)
    # HideAndSeek-family envs emit per-agent entity dicts ([E, n, k, d]);
    # single-env token sets come from SDF/global-obs envs.
    return TransformerPPOPolicy(
        cfg,
        n_agents=env.num_agents,
        action_dim=env.action_dim,
        per_agent_obs=getattr(env, "provides_tp", False),
    )


def make_policy(algo: str, env, overrides: Dict[str, Any] | None = None):
    """Look up + build; mirrors scripts/train.py:176-186."""
    name = algo.lower()
    if name not in ALGOS:
        raise KeyError(f"unknown algo {algo!r}; available: {sorted(ALGOS)}")
    return ALGOS[name](env, overrides or {})


def is_recurrent(policy) -> bool:
    """Recurrent policies thread hidden state through the rollout."""
    return getattr(policy, "recurrent", False)
