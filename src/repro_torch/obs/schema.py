"""The JSONL event-record schema and its validating CLI (a copy of the JAX
package's ``obs/schema.py``: the two validators take the same lines).

Contract (version 1) for every line a ``JsonlSink`` writes:

  required  "v"       int, == SCHEMA_VERSION
            "kind"    non-empty str ("train_step", "engine_tick",
                      "engine_prefill", "engine_summary", ...)
            "t"       unix timestamp, finite number
  optional  "source"  str (which component emitted the line)
            "step"    int >= 0
            "metrics" dict[str, value] where value is None | bool | num |
                      str | (nested) list of values — i.e. strict JSON
                      with finite numbers

Anything else at the top level must itself be a valid metric value.
``python -m repro_torch.obs.schema FILE.jsonl ...`` checks every line of
the files it is given and exits 1 on the first malformed one.

The CLI also takes whole-file ``.json`` records: one pretty-printed JSON
document, not schema-v1 event lines, held to the *value* contract only:
strict JSON (bare ``NaN`` / ``Infinity`` rejected, which ``json.loads``
would otherwise accept), string keys, finite numbers all the way down.
"""
from __future__ import annotations

import json
import sys
from typing import Any

from repro_torch.obs.metrics import SCHEMA_VERSION


class SchemaError(ValueError):
    pass


def _check_value(v: Any, where: str) -> None:
    if v is None or isinstance(v, (bool, str)):
        return
    if isinstance(v, (int, float)):
        if isinstance(v, float) and v != v:           # NaN
            raise SchemaError(f"{where}: non-finite number")
        if isinstance(v, float) and v in (float("inf"), float("-inf")):
            raise SchemaError(f"{where}: non-finite number")
        return
    if isinstance(v, list):
        for i, x in enumerate(v):
            _check_value(x, f"{where}[{i}]")
        return
    if isinstance(v, dict):
        for k, x in v.items():
            if not isinstance(k, str):
                raise SchemaError(f"{where}: non-string key {k!r}")
            _check_value(x, f"{where}.{k}")
        return
    raise SchemaError(f"{where}: unsupported type {type(v).__name__}")


def validate_record(rec: Any) -> None:
    """Raise SchemaError unless ``rec`` is a valid version-1 record."""
    if not isinstance(rec, dict):
        raise SchemaError(f"record is {type(rec).__name__}, not an object")
    v = rec.get("v")
    if v != SCHEMA_VERSION:
        raise SchemaError(f"v={v!r} != schema version {SCHEMA_VERSION}")
    kind = rec.get("kind")
    if not isinstance(kind, str) or not kind:
        raise SchemaError(f"kind={kind!r} must be a non-empty string")
    t = rec.get("t")
    if not isinstance(t, (int, float)) or isinstance(t, bool) or t != t:
        raise SchemaError(f"t={t!r} must be a finite number")
    if "source" in rec and not isinstance(rec["source"], str):
        raise SchemaError(f"source={rec['source']!r} must be a string")
    if "step" in rec:
        s = rec["step"]
        if not isinstance(s, int) or isinstance(s, bool) or s < 0:
            raise SchemaError(f"step={s!r} must be an int >= 0")
    if "metrics" in rec:
        m = rec["metrics"]
        if not isinstance(m, dict):
            raise SchemaError("metrics must be an object")
        _check_value(m, "metrics")
    for k, v in rec.items():
        if k in ("v", "kind", "t", "source", "step", "metrics"):
            continue
        _check_value(v, k)


def validate_jsonl(path: str) -> int:
    """Validate every line of ``path``; returns the line count, raises
    SchemaError (with line number) on the first invalid record."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{lineno}: not JSON ({e})")
            try:
                validate_record(rec)
            except SchemaError as e:
                raise SchemaError(f"{path}:{lineno}: {e}")
            n += 1
    return n


def _reject_constant(name: str):
    raise SchemaError(f"non-finite constant {name} (strict JSON)")


def validate_json_file(path: str) -> None:
    """Validate a whole-file JSON record:
    strict JSON with string keys and finite numbers throughout. Raises
    SchemaError on the first violation."""
    with open(path) as f:
        try:
            doc = json.load(f, parse_constant=_reject_constant)
        except json.JSONDecodeError as e:
            raise SchemaError(f"{path}: not JSON ({e})")
        except SchemaError as e:
            raise SchemaError(f"{path}: {e}")
    try:
        _check_value(doc, "$")
    except SchemaError as e:
        raise SchemaError(f"{path}: {e}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.schema FILE.{jsonl,json} [...]",
              file=sys.stderr)
        return 2
    status = 0
    for path in argv:
        if path.endswith(".json"):
            try:
                validate_json_file(path)
            except (OSError, SchemaError) as e:
                print(f"FAIL {e}", file=sys.stderr)
                status = 1
                continue
            print(f"{path}: whole-file record ok (strict JSON, finite)")
            continue
        try:
            n = validate_jsonl(path)
        except (OSError, SchemaError) as e:
            print(f"FAIL {e}", file=sys.stderr)
            status = 1
            continue
        if n == 0:
            print(f"FAIL {path}: no records", file=sys.stderr)
            status = 1
            continue
        print(f"{path}: {n} records ok (schema v{SCHEMA_VERSION})")
    return status


if __name__ == "__main__":
    sys.exit(main())
