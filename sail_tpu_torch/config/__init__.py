"""Application config: the port's defaults ⊕ SAIL_* environment layering.

Reference role: crates/sail-common/src/config/ (AppConfig with env
layering under the SAIL_ prefix and __ nesting — e.g.
SAIL_CATALOG__PROD__TYPE=memory → catalog.prod.type).

Only the keys the ported code reads have defaults here; a key joins this
table with the code that reads it.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    # comma-separated catalog names, each configured by catalog.<name>.type
    # (only ``memory`` is ported); catalog.default picks the session's
    "catalog.list": "",
    "catalog.default": "",
    # runtime join filters (plan/optimizer.py annotation pass; built and
    # applied by exec/local.py _rtf_conf, session override
    # spark.sail.join.runtimeFilter.*): skip the build under this many
    # usable rows; bloom size in bits; exact in-list scan conjunct up to
    # this many distinct keys; no filter when the source's distinct keys
    # reach this share of the target's estimated rows; a join whose
    # filter pruned less than this share stops building it
    "join.runtime_filter.enabled": True,
    "join.runtime_filter.min_build_rows": 0,
    "join.runtime_filter.max_bits": 1 << 20,
    "join.runtime_filter.in_list_max": 8192,
    "join.runtime_filter.ndv_ratio": 0.75,
    "join.runtime_filter.min_selectivity": 0.02,
    # greedy cost-based join reordering (plan/optimizer.py)
    "optimizer.enable_join_reorder": True,
    # observed leaf-stage rows feed join_reorder's estimates on repeats
    "adaptive.stats_feedback": True,
}


def app_config() -> Dict[str, Any]:
    """Flattened config: the defaults overridden by SAIL_* env vars
    (double underscore nests: SAIL_OPTIMIZER__ENABLE_JOIN_REORDER=false →
    optimizer.enable_join_reorder)."""
    conf = dict(_DEFAULTS)
    for name, value in os.environ.items():
        if not name.startswith("SAIL_"):
            continue
        key = name[len("SAIL_"):].lower().replace("__", ".")
        conf[key] = value
    return conf


def get(key: str, default: Any = None) -> Any:
    return app_config().get(key, default)


def truthy_value(value: Any, default: Any = "true") -> bool:
    """Boolean parse of an already-fetched value (session conf, env):
    everything except 0/false/no/off (any case) is on; None falls back
    to ``default``. The one parser every gate shares, so the accepted
    falsy spellings cannot drift between call sites."""
    if value is None:
        value = default
    return str(value).strip().lower() not in ("0", "false", "no", "off")


def truthy(key: str, default: Any = "true") -> bool:
    """Boolean config key (see :func:`truthy_value`)."""
    return truthy_value(get(key, default))
