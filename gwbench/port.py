"""The program under test, as the benchmark drives it: the port's model of
the configuration's architecture and its deployment sampler
(``serving.build_serving_fn`` with ``resolve_serving_config``'s defaults).

The only module of the benchmark, with the drivers, that imports the port;
the architectures' ``build`` import it through :func:`_m`.
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from . import arch

PORT = "diffusion_models_for_gravitational_waveform_reconstruction_tpu_torch"


def _m(name: str):
    return importlib.import_module(f"{PORT}.{name}")


def build_kernels(device) -> None:
    """Build (or find built, under the port's ``_build/``) every CUDA
    kernel, so that nothing compiles inside a measured window."""
    if torch.device(device).type == "cuda":
        _m("ops.kernels._build").build_all()


def launch_counts() -> Dict[str, int]:
    return _m("ops.kernels").launch_counts()


def dtype_of(config: dict):
    return {"bfloat16": torch.bfloat16, "float32": None}[config["dtype"]]


def model(config: dict, params: Dict[str, torch.Tensor], device):
    """The port's model of the configuration's architecture with ``params``
    copied in, for inference: ``arch/<arch>.py``'s ``build``."""
    return arch.of(config["model"]).build(config, params, device)


def serving_fn(config: dict, traffic: dict, device):
    """The deployment sampler of the configuration's checkpoint contract at
    the traffic's step count."""
    m = config["model"]
    schedule = _m("ops.schedules").make_schedule(config["T"],
                                                 config["schedule"])
    ck = {"in_ch": m["in_ch"], "cond_in_ch": m["cond_in_ch"],
          "pred_type": config["pred_type"], "dropout_y_only": True,
          "selfcond_mode": "update"}
    serving = _m("serving")
    cfg, sampler = serving.resolve_serving_config(
        ck, schedule, sampler="ddim", steps=traffic["steps"])
    return serving.build_serving_fn(
        schedule, cfg, sampler=sampler, avg_seeds=traffic["avg_seeds"],
        avg_mode="mean", amp_calib="mf", device=device), cfg
