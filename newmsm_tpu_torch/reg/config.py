"""Registration configuration: parses the reference's config files verbatim
(a file of `--flag=value[,value...]` lines, parse_reg_options,
mesh_registration.cpp:459-784) and applies the same defaults/validation.
The port's own copy of the JAX package's reg/config.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class RegConfig:
    cost: List[str] = field(default_factory=list)           # --opt per level
    simval: List[int] = field(default_factory=list)
    iters: List[int] = field(default_factory=list)
    sigma_in: List[float] = field(default_factory=list)
    sigma_ref: List[float] = field(default_factory=list)
    reglambda: List[float] = field(default_factory=list)    # --lambda
    datagrid: List[int] = field(default_factory=list)       # --datagrid (_genesis)
    cpgrid: List[int] = field(default_factory=list)         # --CPgrid
    sampgrid: List[int] = field(default_factory=list)       # --SGgrid
    anatgrid: List[int] = field(default_factory=list)
    mciters: List[int] = field(default_factory=list)
    cutthreshold: List[float] = field(default_factory=lambda: [0.0, 0.0001])
    regmode: int = 1
    dopt: str = "FastPD"
    triclique: bool = False
    patchwise: bool = False
    shearmod: float = 0.4
    bulkmod: float = 1.6
    k_exponent: float = 2.0
    regexp: float = 2.0
    fixnan: bool = False
    rescaleL: bool = False
    cprange: float = 1.0
    intensity_norm: bool = False
    cut: bool = False
    variance_norm: bool = False
    exclude: bool = False
    stepsize: float = 0.01
    gradsampling: float = 0.5
    mcparam: float = 0.8
    percentile: float = 0.75
    numthreads: int = 1
    verbose: bool = False

    @property
    def levels(self) -> int:
        return len(self.cost)


_LIST_FLAGS = {
    "opt": ("cost", str),
    "simval": ("simval", int),
    "it": ("iters", int),
    "sigma_in": ("sigma_in", float),
    "sigma_ref": ("sigma_ref", float),
    "lambda": ("reglambda", float),
    "datagrid": ("datagrid", int),
    "CPgrid": ("cpgrid", int),
    "SGgrid": ("sampgrid", int),
    "anatgrid": ("anatgrid", int),
    "cutthr": ("cutthreshold", float),
    "mciters": ("mciters", int),
}
_SCALAR_FLAGS = {
    "regoption": ("regmode", int),
    "dopt": ("dopt", str),
    "shearmod": ("shearmod", float),
    "bulkmod": ("bulkmod", float),
    "k_exponent": ("k_exponent", float),
    "regexp": ("regexp", float),
    "cprange": ("cprange", float),
    "stepsize": ("stepsize", float),
    "gradsampling": ("gradsampling", float),
    "mcparam": ("mcparam", float),
    "percentile": ("percentile", float),
    "numthreads": ("numthreads", int),
}
_BOOL_FLAGS = {
    "triclique": "triclique",
    "patchwise": "patchwise",
    "fixnan": "fixnan",
    "rescaleL": "rescaleL",
    "IN": "intensity_norm",
    "VN": "variance_norm",
    "excl": "exclude",
}


def _default_config() -> RegConfig:
    """The hard-coded sulc default when no config file is given
    (mesh_registration.cpp:627-642)."""
    cfg = RegConfig()
    cfg.cost = ["RIGID", "DISCRETE", "DISCRETE", "DISCRETE"]
    cfg.reglambda = [0, 0.1, 0.2, 0.3]
    cfg.simval = [1, 2, 2, 2]
    cfg.sigma_in = [2, 2, 3, 2]
    cfg.sigma_ref = [2, 2, 1.5, 1]
    cfg.iters = [50, 3, 3, 3]
    cfg.cpgrid = [0, 2, 3, 4]
    cfg.anatgrid = [0, 4, 5, 6]
    cfg.datagrid = [4, 4, 5, 6]
    cfg.sampgrid = [0, 4, 5, 6]
    cfg.mciters = [100000] * 4
    return cfg


def parse_config(path: str | None) -> RegConfig:
    if not path:
        return _default_config()

    cfg = RegConfig()
    raw: dict[str, str | None] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not line.startswith("--"):
                raise ValueError(f"config line must start with --: {line!r}")
            body = line[2:]
            if "=" in body:
                key, val = body.split("=", 1)
                raw[key.strip()] = val.strip()
            else:
                raw[body.strip()] = None

    for key, val in raw.items():
        if key in _LIST_FLAGS:
            attr, typ = _LIST_FLAGS[key]
            setattr(cfg, attr, [typ(x) for x in val.split(",")])
        elif key in _SCALAR_FLAGS:
            attr, typ = _SCALAR_FLAGS[key]
            setattr(cfg, attr, typ(val))
        elif key in _BOOL_FLAGS:
            setattr(cfg, _BOOL_FLAGS[key], True)
        elif key == "INc":
            cfg.intensity_norm = True
            cfg.cut = True
        else:
            raise ValueError(f"unknown config option --{key}")

    n = len(cfg.cost)
    if n == 0:
        raise ValueError("config must set --opt")
    # defaults (mesh_registration.cpp:643-716)
    if not cfg.simval:
        cfg.simval = [2] * n
    cfg.simval = [2 if s == 3 else s for s in cfg.simval]  # NMI removed
    if not cfg.iters:
        cfg.iters = [3] * n
    if not cfg.sigma_in:
        cfg.sigma_in = [2.0] * n
    if not cfg.sigma_ref:
        cfg.sigma_ref = list(cfg.sigma_in)
    if not cfg.datagrid:
        cfg.datagrid = [5] * n
    if not cfg.cpgrid:
        cfg.cpgrid = [2 + i for i in range(n)]
    if not cfg.anatgrid:
        cfg.anatgrid = [g + 2 for g in cfg.cpgrid]
    if not cfg.sampgrid:
        cfg.sampgrid = [g + 2 for g in cfg.cpgrid]
    if not cfg.mciters:
        cfg.mciters = [100000] * n
    if not cfg.reglambda:
        cfg.reglambda = [0.0] * n
    if cfg.dopt == "FastPD":
        cfg.regmode = 1   # mesh_registration.cpp:693

    # validation (mesh_registration.cpp:758-783; regmode-4 removal :102)
    if cfg.regmode == 4:
        raise ValueError(
            "--regoption 4 has been removed from newMSM. Use --regoption 3 "
            "for spherical mesh regularisation or --regoption 5 for "
            "anatomical mesh regularisation.")
    if cfg.regmode > 1 and cfg.dopt == "FastPD":
        raise ValueError("cannot run higher-order regularisers with FastPD")
    if len(cfg.cutthreshold) != 2:
        raise ValueError("cut threshold needs exactly lower,upper")
    for name in ("simval", "iters", "sigma_in", "sigma_ref", "cost",
                 "reglambda", "datagrid", "cpgrid", "sampgrid",
                 "anatgrid", "mciters"):
        if len(getattr(cfg, {"cost": "cost"}.get(name, name))) != n:
            raise ValueError(f"config list length inconsistent: {name}")
    if cfg.patchwise and cfg.triclique:
        raise ValueError("cannot use patchwise and triclique together")
    if not (1e-8 < cfg.percentile < 1 - 1e-8):
        raise ValueError("percentile must be between 0 and 1")
    return cfg
