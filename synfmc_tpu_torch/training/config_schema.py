"""Config-surface validation: strict drop-in parity with ``main(**config)``.

The port's copy of synfmc_tpu/training/config_schema.py: the same legal
keys, notes and refusals, so a config the JAX trainer refuses the port
refuses too (the keys the port has not ported raise NotImplementedError in
``training/trainers.py`` after this check).

The reference splats the whole YAML into ``main(**config)``
(train_cam_ctrl.py:797-806), so a mistyped or unsupported key raises
``TypeError`` before anything runs.  Our ``train(stage, config)`` reads keys
with ``config.get(...)`` — without this module a typo would be silently
ignored and the run would look healthy while using a default.

``validate_config`` restores the reference's strictness and extends it to the
nested structural kwargs this rebuild pins statically:

- unknown TOP-LEVEL keys → ``ValueError`` with a did-you-mean suggestion
  (the ``main(**config)`` TypeError equivalent);
- nested ``unet_additional_kwargs`` / ``pose_encoder_kwargs`` /
  ``attention_processor_kwargs`` / ``omcm_config`` values that the static
  module configuration cannot express → loud ``ValueError`` instead of a
  silent ignore (the class of gap VERDICT r3 flagged for stage-1
  ``use_flip``);
- keys that are accepted but inert — inert in the REFERENCE too (declared in
  ``main`` and never read), or N/A on TPU — produce log notes, not errors.

``train_data.params`` / ``omcm_config.params`` are splatted into strict
constructors (``dataset_cls(**params)`` raises ``TypeError`` on typos), and
``noise_scheduler_kwargs`` is signature-checked against
``DiffusionSchedule.from_config`` here; ``validation_data`` is an open dict
in the reference as well (consumed piecemeal), so only its type is checked.
"""

from __future__ import annotations

import difflib
import inspect
from typing import Any, Iterable, Mapping, Optional

# ---------------------------------------------------------------------------
# the legal key surface
# ---------------------------------------------------------------------------

# Exactly the reference main() parameter names (the YAML is splatted into
# main, so these ARE the reference's legal top-level keys):
# train_image_lora.py:65-118, train_cam_ctrl.py:124-187,
# train_cam_obj_ctrl.py:125-197.
_REF_COMMON = frozenset({
    "name", "launcher", "port", "output_dir", "pretrained_model_path",
    "train_data", "validation_data", "cfg_random_null_text",
    "cfg_random_null_text_ratio", "unet_subfolder", "lora_rank",
    "noise_scheduler_kwargs", "do_sanity_check", "max_train_epoch",
    "max_train_steps", "validation_steps", "validation_steps_tuple",
    "learning_rate", "lr_warmup_steps", "lr_scheduler", "num_workers",
    "train_batch_size", "adam_beta1", "adam_beta2", "adam_weight_decay",
    "adam_epsilon", "max_grad_norm", "gradient_accumulation_steps",
    "checkpointing_epochs", "checkpointing_steps",
    "mixed_precision_training", "global_seed", "logger_interval",
    "resume_from",
})

_REF_VIDEO = _REF_COMMON | frozenset({
    # shared by the cam + obj stages (train_cam_ctrl.py:139-187)
    "unet_additional_kwargs", "lora_scale", "lora_ckpt",
    "motion_module_ckpt", "motion_lora_rank", "motion_lora_scale",
    "pose_encoder_kwargs", "attention_processor_kwargs",
    "apply_masked_loss", "mask_loss_weight", "sd_loss_weight",
    "appearance_debias", "is_debug", "train_unet", "train_mm",
})

REFERENCE_KEYS: dict[str, frozenset] = {
    "lora": _REF_COMMON | frozenset({
        "enable_xformers_memory_efficient_attention", "gradient_checkpointing",
    }),
    "cam": _REF_VIDEO,
    "obj": _REF_VIDEO | frozenset({
        # train_cam_obj_ctrl.py:158-196
        "omcm_config", "pretrained_cm_path", "train_cm", "train_image_lora",
        "omcm_min_step", "min_step_prob", "use_constant_loss",
        "constant_loss_weight",
    }),
}

# Keys this rebuild adds (documented in README/MIGRATION; every one is read
# by trainers.py or scripts/train.py).
EXTENSION_KEYS = frozenset({
    "mesh",                       # {data, fsdp, sp} parallelism knobs
    "model_overrides",            # shrink every module (tests/benchmarks)
    "prefetch_batches",           # input-pipeline lookahead depth
    "async_checkpointing",        # serialize checkpoints off the hot loop
    "ckpt_device_snapshot",       # always|never|auto HBM snapshot policy
    "checkpoint_on_preemption",   # SIGTERM -> checkpoint + clean exit
    "strict_pretrained",          # missing ckpt paths are fatal
    "allow_untrained_cm",         # stage-3 smoke runs without a CMC ckpt
    "record_loss_history",        # per-step loss record (tests only)
    "enable_validation",          # gate the in-training render passes
    "profile_steps",              # profiler trace window
    "gradient_checkpointing",     # remat (reference: lora only; ours: all)
    "gradient_checkpointing_policy",
    "allow_unknown_config_keys",  # downgrade unknown-key errors to notes
})

# Accepted-but-inert keys -> the note logged when present.  Each is inert in
# the reference too, or N/A on TPU; silently dropping them would hide that.
INERT_KEYS: dict[str, str] = {
    "launcher": "CLI-era key; JAX needs no launcher (scripts/train.py --distributed)",
    "port": "CLI-era key; JAX needs no rendezvous port",
    "train_unet": "inert in the reference too (declared train_cam_ctrl.py:185, never read)",
    "is_debug": "inert in the reference too (declared train_cam_ctrl.py:184, never read)",
    "use_constant_loss": "the constant-loss term is commented out in the reference "
                         "(train_cam_obj_ctrl.py:846-915); accepted and ignored",
    "constant_loss_weight": "see use_constant_loss",
    "enable_xformers_memory_efficient_attention":
        "N/A on TPU: the Pallas flash-attention kernels are always on (SURVEY §2.7)",
}


# ---------------------------------------------------------------------------
# nested structural kwargs
# ---------------------------------------------------------------------------

# attention_processor_kwargs (cam.yaml:121-129): the reference dispatches
# processors by reflection (unet.py:897-1031); this rebuild pins the released
# configuration statically (temporal-only pose conditioning with the
# q=k=v-conditioned merge).  `scale` and `temporal_attn_names` are honored
# (UNet3D.pose_scale / pose_cond_blocks); the rest must match the supported
# configuration or fail loud.
_ATTN_PROC_KEYS = frozenset({
    "add_spatial", "spatial_attn_names", "add_temporal", "temporal_attn_names",
    "pose_feature_dimensions", "query_condition", "key_value_condition", "scale",
})

# pose_encoder_kwargs (cam.yaml:106-120): `channels`, `downscale_factor`,
# `nums_rb`, `ksize`, `temporal_attention_nhead`,
# `temporal_position_encoding_max_len` are honored by build_models; the
# structural booleans must match the single configuration the released
# checkpoints use (pose_adaptor.py:159-240: sk=True skip-connected resblocks,
# no conv shortcut, no compression, Temporal_Self attention with PE).
_POSE_ENC_KEYS = frozenset({
    "downscale_factor", "channels", "nums_rb", "cin", "ksize", "sk",
    "use_conv", "compression_factor", "temporal_attention_nhead",
    "attention_block_types", "temporal_position_encoding",
    "temporal_position_encoding_max_len",
})

_UNET_ADD_KEYS = frozenset({
    "use_motion_module", "motion_module_resolutions", "motion_module_mid_block",
    "motion_module_type", "motion_module_kwargs",
    "unet_use_cross_frame_attention", "unet_use_temporal_attention",
})

_MOTION_MODULE_KEYS = frozenset({
    "num_attention_heads", "num_transformer_block", "attention_block_types",
    "temporal_position_encoding", "temporal_position_encoding_max_len",
    "temporal_attention_dim_div", "zero_initialize",
})

_OMCM_PARAM_KEYS = frozenset({
    # fmc/adapter.py:110-112 Adapter.__init__
    "channels", "nums_rb", "cin", "ksize", "sk", "use_conv",
    "align_training_size", "use_pre_zero_conv", "use_post_zero_conv",
})


class ConfigError(ValueError):
    """A config key/value the framework cannot honor (fail loud, not silent)."""


def _suggest(key: str, legal: Iterable[str]) -> str:
    close = difflib.get_close_matches(key, list(legal), n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


def _check_keys(d: Mapping, legal: frozenset, where: str) -> None:
    unknown = sorted(set(d) - legal)
    if unknown:
        hints = "".join(_suggest(k, legal) for k in unknown[:1])
        raise ConfigError(
            f"unknown {where} key(s): {unknown}{hints} — the reference would "
            f"raise TypeError here (main(**config)); set "
            f"allow_unknown_config_keys: true to bypass for top-level keys"
        )


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ConfigError(msg)


def _norm_attn_names(v) -> tuple[int, ...]:
    """temporal_attn_names ('0', 0, [0, 1], '0,1') -> block indices."""
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return tuple(int(x) for x in str(v).split(","))


def validate_config(config: Mapping[str, Any], stage: str,
                    logger: Optional[Any] = None) -> list[str]:
    """Validate a stage config; returns the notes logged for inert keys.

    Raises ``ConfigError`` on unknown top-level keys (unless
    ``allow_unknown_config_keys``) and on nested structural values the static
    rebuild cannot express.
    """
    assert stage in REFERENCE_KEYS, stage
    notes: list[str] = []
    legal = REFERENCE_KEYS[stage] | EXTENSION_KEYS
    unknown = sorted(set(config) - legal)
    if unknown:
        msg = (
            f"unknown config key(s) for stage {stage!r}: {unknown}"
            + "".join(_suggest(k, legal) for k in unknown[:1])
            + " — the reference would raise TypeError here (main(**config))"
        )
        if config.get("allow_unknown_config_keys"):
            notes.append(f"allow_unknown_config_keys: ignoring {unknown}")
        else:
            raise ConfigError(msg + "; set allow_unknown_config_keys: true to bypass")

    for key, why in INERT_KEYS.items():
        if key in config:
            notes.append(f"config key {key!r} accepted but inert: {why}")

    apk = config.get("attention_processor_kwargs")
    if apk:
        _check_keys(apk, _ATTN_PROC_KEYS, "attention_processor_kwargs")
        _require(not apk.get("add_spatial", False),
                 "attention_processor_kwargs.add_spatial=true is not supported: "
                 "the released SynFMC configuration conditions TEMPORAL attention "
                 "only (cam.yaml:122); spatial pose conditioning has no static "
                 "variant in this rebuild")
        _require(bool(apk.get("add_temporal", True)),
                 "attention_processor_kwargs.add_temporal=false disables camera "
                 "conditioning entirely — remove pose_encoder_kwargs instead")
        _require(bool(apk.get("query_condition", True))
                 and bool(apk.get("key_value_condition", True)),
                 "attention_processor_kwargs.{query,key_value}_condition must both "
                 "be true: the merge attention implements the q=k=v-conditioned "
                 "variant the released checkpoints use (cam.yaml:127-128, "
                 "attention_processor.py:255-258)")
        dims = apk.get("pose_feature_dimensions")
        overridden = bool((config.get("model_overrides") or {}).get("block_out_channels"))
        if dims is not None and not overridden:
            # model_overrides deliberately shrinks every module below the
            # YAML's literal dims (tests/benchmarks), so the check applies
            # only to the un-overridden configuration
            chs = _block_channels(config)
            _require(tuple(dims) == chs,
                     f"attention_processor_kwargs.pose_feature_dimensions {tuple(dims)} "
                     f"must equal the UNet block channels {chs}")

    pek = config.get("pose_encoder_kwargs")
    if pek:
        _check_keys(pek, _POSE_ENC_KEYS, "pose_encoder_kwargs")
        _require(bool(pek.get("sk", True)) and not pek.get("use_conv", False)
                 and int(pek.get("compression_factor", 1)) == 1,
                 "pose_encoder_kwargs must use the released resblock shape "
                 "(sk=true, use_conv=false, compression_factor=1 — "
                 "pose_adaptor.py:102-135); other variants are not built")
        abt = list(pek.get("attention_block_types", ["Temporal_Self"]))
        _require(abt == ["Temporal_Self"],
                 f"pose_encoder_kwargs.attention_block_types {abt}: only "
                 f"['Temporal_Self'] exists (the reference's other block types "
                 f"are dead code, SURVEY §2 motion_module)")
        _require(bool(pek.get("temporal_position_encoding", True)),
                 "pose_encoder_kwargs.temporal_position_encoding=false is not a "
                 "released configuration")
        cin = pek.get("cin")
        if cin is not None:
            ds = int(pek.get("downscale_factor", 8))
            _require(int(cin) == 6 * ds * ds,
                     f"pose_encoder_kwargs.cin {cin} must equal 6*downscale^2 "
                     f"= {6 * ds * ds} (PixelUnshuffle of the 6-ch Plücker video)")

    uak = config.get("unet_additional_kwargs")
    if uak:
        _check_keys(uak, _UNET_ADD_KEYS, "unet_additional_kwargs")
        mmt = uak.get("motion_module_type", "Vanilla")
        _require(mmt == "Vanilla",
                 f"motion_module_type {mmt!r}: only 'Vanilla' exists "
                 f"(motion_module.py:32-41)")
        _require(not uak.get("unet_use_cross_frame_attention", False)
                 and not uak.get("unet_use_temporal_attention", False),
                 "unet_use_cross_frame_attention / unet_use_temporal_attention "
                 "route to the reference's unused Transformer3DModel "
                 "(SURVEY §2.2 attention.py: dead code) and are not built")
        mmk = uak.get("motion_module_kwargs")
        if mmk:
            _check_keys(mmk, _MOTION_MODULE_KEYS, "motion_module_kwargs")
            _require(int(mmk.get("temporal_attention_dim_div", 1)) == 1,
                     "motion_module_kwargs.temporal_attention_dim_div must be 1 "
                     "(the AnimateDiff-v3 weights use the full inner dim)")
            abt = list(mmk.get("attention_block_types",
                               ["Temporal_Self", "Temporal_Self"]))
            _require(all(t == "Temporal_Self" for t in abt),
                     f"motion_module_kwargs.attention_block_types {abt}: the "
                     f"causal/cross variants are dead code in the reference "
                     f"(motion_module.py:155-208) and are not built")
            _require(bool(mmk.get("temporal_position_encoding", True)),
                     "motion_module_kwargs.temporal_position_encoding=false is "
                     "not a released configuration")

    omcm = config.get("omcm_config")
    if omcm:
        _check_keys(omcm, frozenset({"params", "pretrained", "target"}), "omcm_config")
        op = omcm.get("params")
        if op:
            _check_keys(op, _OMCM_PARAM_KEYS, "omcm_config.params")
            _require(bool(op.get("sk", True)) and not op.get("use_conv", False),
                     "omcm_config.params must use the released Adapter resblock "
                     "shape (sk=true, use_conv=false, obj.yaml:175-192)")
            cin = op.get("cin")
            if cin is not None:
                _require(int(cin) == 13 * 64,
                         f"omcm_config.params.cin {cin} must be 832 = 13ch x "
                         f"PixelUnshuffle(8) (adapter.py:128, obj.yaml:185)")

    gas = config.get("gradient_accumulation_steps")
    if gas is not None:
        _require(int(gas) >= 1,
                 f"gradient_accumulation_steps must be >= 1, got {gas}")

    nsk = config.get("noise_scheduler_kwargs")
    if nsk:
        from synfmc_tpu_torch.diffusion.scheduler import DiffusionSchedule

        # Strict by name (the **_unused catch-all in from_config is excluded):
        # a silently-dropped scheduler kwarg like prediction_type would change
        # the loss target while looking healthy.
        sig = inspect.signature(DiffusionSchedule.from_config)
        legal_ns = frozenset(
            name for name, p in sig.parameters.items()
            if name != "cls" and p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)
        )
        _check_keys(nsk, legal_ns, "noise_scheduler_kwargs")

    vd = config.get("validation_data")
    if vd is not None:
        _require(isinstance(vd, Mapping), "validation_data must be a mapping")

    if logger is not None:
        for n in notes:
            logger.info(n)
    return notes


def _block_channels(config: Mapping[str, Any]) -> tuple[int, ...]:
    ov = config.get("model_overrides") or {}
    return tuple(ov.get("block_out_channels", (320, 640, 1280, 1280)))
