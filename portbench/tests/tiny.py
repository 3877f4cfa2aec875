"""A tiny configuration and traffic of each driver, for runs on the CPU."""

from __future__ import annotations

import copy

from portbench.common import Spec

CONFIG = {
    "name": "tiny",
    "cvivit": {"dim": 32, "codebook_size": 64, "image_size": [32, 16], "patch_size": 16,
               "temporal_patch_size": 2, "spatial_depth": 1, "temporal_depth": 1, "dim_head": 16, "heads": 2},
    "maskgit": {"dim": 32, "num_tokens": 64, "max_seq_len": 8, "depth": 2, "dim_head": 16, "heads": 2,
                "dim_context": 24},
    "sampling": {"num_frames": 5, "steps": 4, "text_dim": 24, "max_text_len": 8},
    "precision": {"serve": "float32", "train_params": "float32", "train_compute": "float32"},
}

TRAFFIC = {
    "sample": {"driver": "sample", "batch": 3, "cond_scale": 5.0, "starting_temperature": 0.9, "prompts": 5,
               "text_len": [2, 6], "warmup_calls": 1, "profile_calls": 1, "check_calls": 2,
               "check_among_first": 2, "critic_check_steps": 2,
               "limits": {"pick_gap": 1e-3, "kept_ids": 0, "bad_ids": 0, "critic_err": 1e-3, "frame_err": 1e-3}},
    "train": {"driver": "train", "batch": 4, "dataset_clips": 16, "text_len": [2, 6], "lr": 1e-3,
              "betas": [0.9, 0.99], "cond_drop_prob": 0.25, "sample_texts": ["a", "b"], "milestone_clips": 1,
              "profile_steps": 1, "reference_block": 2,
              "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}},
    "serve": {"driver": "serve", "rate": 20.0, "text_len": [2, 6], "profile_launches": 1, "check_requests": 3,
              "limits": {"pick_gap": 1e-3, "kept_ids": 0, "bad_ids": 0, "frame_levels": 1, "launch_records": 0}},
}


def config(critic: bool = False) -> dict:
    c = copy.deepcopy(CONFIG)
    if critic:
        c["critic"] = dict(c["maskgit"])
    return c


def spec(driver: str, *, critic: bool = False, seed: int = 2**31 + 5, seconds: float = 1.0, trace: bool = False,
         control: bool = False, **traffic) -> Spec:
    t = dict(copy.deepcopy(TRAFFIC[driver]), **traffic)
    t["_per_layer"] = []
    return Spec(workload=f"tiny-{driver}", config=config(critic), traffic=t, seed=seed, seconds=seconds,
                trace=trace, device="cpu", control=control)
