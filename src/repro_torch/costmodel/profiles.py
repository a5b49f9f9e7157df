"""Hardware characterization tables: file formats, schema, validation
(counterpart of `repro.costmodel.profiles`).

A profile is a set of named sections of scalar keys. Two on-disk formats
are accepted, resolved by extension:

  * `.csv` — sectioned CSV in the shape of the ESL-CGRA simulator's
    `characterization.py` tables: a `# section.name` row opens a section,
    following `key,value` rows populate it, blank rows are ignored.
  * `.toml` — the same sections as TOML tables (`[pipeline]`,
    `[memory.iwe]`, ...). Parsed with `tomllib` (3.11+) or `tomli` when
    available; loading a TOML profile without either raises ProfileError.

Every profile must carry exactly the sections/keys of `SCHEMA` (plus the
free-form `meta` extras listed in `_META_OPTIONAL`): a missing section or
key raises `MissingSectionError` / `ProfileError`, an unknown one raises
`UnknownKeyError` — characterization tables are calibration data, so a
typo must fail loudly rather than silently fall back to a default.

This module is deliberately model-free (plain dicts in, plain dicts out);
`costmodel.model` turns a validated dict into `HwParams`.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List

PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "profiles")

MEMORY_GROUPS = ("iwe", "raw", "sort", "line")

# section -> key -> required python type (int accepted where float is asked)
SCHEMA: Dict[str, Dict[str, type]] = {
    "meta": {
        "name": str,
        "description": str,
        "source": str,
    },
    "pipeline": {
        "freq_hz": float,
        "camel_cyc_per_event": float,
        "base_cyc_per_event": float,
        "base_rmw_stall": float,
        "blur_px_per_cyc": float,
        "pass_overhead_cyc": float,
        "sort_cyc_per_event": float,
        "real_time_bound_s": float,
        "vote_taps": int,
        "channels": int,
    },
    "logic": {
        "camel_mw": float,
        "baseline_mw": float,
    },
    **{f"memory.{g}": {"e_read_pj": float, "e_write_pj": float,
                       "leak_mw": float, "size_kb": int}
       for g in MEMORY_GROUPS},
}

# meta keys that MAY appear (provenance notes); everything else is a typo
_META_OPTIONAL = {"technology", "calibration"}

# sections that MAY appear. `roofline` carries the chip-level machine
# balance (peak compute, HBM/interconnect bandwidth, HBM capacity in
# bytes) that roofline/analysis.py sources its HW constants from — only
# accelerator-class profiles ship it; the FPGA/ASIC tables have no
# meaningful "peak FLOP/s" and omit it.
OPTIONAL_SECTIONS: Dict[str, Dict[str, type]] = {
    "roofline": {
        "peak_flops": float,      # FLOP/s per chip (bf16 where relevant)
        "hbm_bw": float,          # B/s per chip
        "link_bw": float,         # B/s per interconnect link
        "hbm_per_chip": float,    # bytes
    },
}

# keys that must be strictly positive once validated
_POSITIVE = {("pipeline", k) for k in ("freq_hz", "camel_cyc_per_event",
                                       "base_cyc_per_event", "base_rmw_stall",
                                       "blur_px_per_cyc", "vote_taps",
                                       "channels")} \
    | {("roofline", k) for k in ("peak_flops", "hbm_bw", "link_bw",
                                 "hbm_per_chip")}


class ProfileError(ValueError):
    """A characterization table failed to load or validate."""


class MissingSectionError(ProfileError):
    """A required section (or key within it) is absent."""


class UnknownKeyError(ProfileError):
    """A section or key not in the schema — almost certainly a typo."""


def available_profiles() -> List[str]:
    """Names of the shipped profiles (file stem, sans extension)."""
    names = []
    for fn in sorted(os.listdir(PROFILE_DIR)):
        stem, ext = os.path.splitext(fn)
        if ext in (".csv", ".toml"):
            names.append(stem)
    return names


def _resolve(name_or_path: str) -> str:
    if os.path.sep in name_or_path or name_or_path.endswith((".csv",
                                                             ".toml")):
        if not os.path.exists(name_or_path):
            raise ProfileError(f"no such profile file: {name_or_path}")
        return name_or_path
    for ext in (".csv", ".toml"):
        path = os.path.join(PROFILE_DIR, name_or_path + ext)
        if os.path.exists(path):
            return path
    raise ProfileError(
        f"unknown profile {name_or_path!r}; shipped profiles: "
        f"{', '.join(available_profiles())}")


def _parse_scalar(text: str):
    text = text.strip()
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def _parse_csv(path: str) -> Dict[str, Dict[str, object]]:
    sections: Dict[str, Dict[str, object]] = {}
    current = None
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or not row[0].strip():
                continue
            if row[0].lstrip().startswith("#"):
                current = row[0].lstrip().lstrip("#").strip()
                if current:
                    sections.setdefault(current, {})
                continue
            if current is None:
                raise ProfileError(
                    f"{os.path.basename(path)}: data row {row!r} before "
                    "any '# section' header")
            if len(row) < 2:
                raise ProfileError(
                    f"{os.path.basename(path)}: row {row!r} in section "
                    f"{current!r} has no value")
            key = row[0].strip()
            value = ",".join(row[1:]) if current == "meta" \
                else row[1]
            sections[current][key] = _parse_scalar(value) \
                if current != "meta" else value.strip()
    return sections


def _parse_toml(path: str) -> Dict[str, Dict[str, object]]:
    try:
        import tomllib as toml_mod
    except ImportError:
        try:
            import tomli as toml_mod
        except ImportError:
            raise ProfileError(
                f"{os.path.basename(path)}: TOML profiles need tomllib "
                "(py311+) or tomli; re-encode the profile as sectioned CSV")
    with open(path, "rb") as f:
        data = toml_mod.load(f)
    sections: Dict[str, Dict[str, object]] = {}
    for sec, body in data.items():
        if not isinstance(body, dict):
            raise ProfileError(
                f"{os.path.basename(path)}: top-level key {sec!r} is not "
                "a section table")
        # one nesting level: [memory.iwe] arrives as memory -> {iwe: {...}}
        if all(isinstance(v, dict) for v in body.values()) and body:
            for sub, subbody in body.items():
                sections[f"{sec}.{sub}"] = dict(subbody)
        else:
            sections[sec] = dict(body)
    return sections


def validate(sections: Dict[str, Dict[str, object]], origin: str = "profile"
             ) -> Dict[str, Dict[str, object]]:
    """Check a parsed profile against SCHEMA; returns it (with ints
    accepted for float keys coerced to float)."""
    out: Dict[str, Dict[str, object]] = {}
    for sec in sections:
        if sec not in SCHEMA and sec not in OPTIONAL_SECTIONS:
            raise UnknownKeyError(
                f"{origin}: unknown section {sec!r} (expected one of "
                f"{sorted(set(SCHEMA) | set(OPTIONAL_SECTIONS))})")
    required = dict(SCHEMA)
    required.update({sec: keys for sec, keys in OPTIONAL_SECTIONS.items()
                     if sec in sections})
    for sec, keys in required.items():
        if sec not in sections:
            raise MissingSectionError(f"{origin}: missing section {sec!r}")
        body = sections[sec]
        out[sec] = {}
        for key in body:
            if key in keys:
                continue
            if sec == "meta" and key in _META_OPTIONAL:
                continue
            raise UnknownKeyError(
                f"{origin}: unknown key {key!r} in section {sec!r} "
                f"(expected {sorted(keys)})")
        for key, typ in keys.items():
            if key not in body:
                raise MissingSectionError(
                    f"{origin}: section {sec!r} is missing key {key!r}")
            val = body[key]
            if typ is float and isinstance(val, int) \
                    and not isinstance(val, bool):
                val = float(val)
            if not isinstance(val, typ) or isinstance(val, bool):
                raise ProfileError(
                    f"{origin}: {sec}.{key} must be {typ.__name__}, got "
                    f"{type(val).__name__} ({val!r})")
            if (sec, key) in _POSITIVE and val <= 0:
                raise ProfileError(
                    f"{origin}: {sec}.{key} must be > 0, got {val!r}")
            out[sec][key] = val
        if sec == "meta":
            for key in _META_OPTIONAL & set(body):
                out[sec][key] = body[key]
    return out


def read_profile_dict(name_or_path: str) -> Dict[str, Dict[str, object]]:
    """Load + validate a characterization table into nested dicts."""
    path = _resolve(name_or_path)
    parser = _parse_toml if path.endswith(".toml") else _parse_csv
    return validate(parser(path), origin=os.path.basename(path))


def paper_trace() -> dict:
    """The checked-in measured pipeline trace (per-window stage stats from
    the paper-scale 40k-event poster run) that the paper-validation checks
    replay — pure arithmetic, no pipeline execution. A byte-identical copy
    of the reference package's trace."""
    with open(os.path.join(PROFILE_DIR, "paper_trace_40k.json")) as f:
        return json.load(f)
