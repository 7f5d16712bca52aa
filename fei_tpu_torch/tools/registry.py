"""Tool registry: name→tool map, JSON-schema argument validation, dispatch.

Capability parity with the reference's ToolRegistry (fei/tools/registry.py:49-607):
registration, schema validation, sync/async handler dispatch, MCP passthrough
tools, and reflection-based registration of class methods. Differences by
design: validation errors raise typed ToolValidationError (the reference
returns ad-hoc dicts), async handlers run on the caller's loop via
``asyncio.run`` in a worker thread only when no loop is available (the
reference spawns a nested event loop per call — a known race, FLAWS.md).

A copy of ``fei_tpu/tools/registry.py`` that imports only the port.
"""

from __future__ import annotations

import asyncio
import inspect
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable

from fei_tpu_torch.utils.errors import ToolError, ToolNotFoundError, ToolValidationError
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("tools.registry")

_JSON_TYPES = {
    "string": str,
    "integer": int,
    "number": (int, float),
    "boolean": bool,
    "array": list,
    "object": dict,
    "null": type(None),
}


def validate_schema(args: dict, schema: dict, path: str = "") -> list[str]:
    """Validate ``args`` against a (subset of) JSON schema; return error strings.

    Supports: type, required, properties, items, enum, minimum/maximum,
    minLength/maxLength, pattern, additionalProperties. Mirrors the checks the
    reference does in Tool.validate_arguments (fei/tools/registry.py:92-153).
    """
    errors: list[str] = []
    typ = schema.get("type")
    if typ:
        expected = _JSON_TYPES.get(typ)
        if expected is not None and not isinstance(args, expected):
            # JSON has no int/float distinction for "number"; bools are not ints
            if not (typ == "number" and isinstance(args, (int, float))):
                errors.append(f"{path or 'value'}: expected {typ}, got {type(args).__name__}")
                return errors
        if typ == "integer" and isinstance(args, bool):
            errors.append(f"{path or 'value'}: expected integer, got bool")
            return errors
    if "enum" in schema and args not in schema["enum"]:
        errors.append(f"{path or 'value'}: {args!r} not one of {schema['enum']}")
    if isinstance(args, str):
        if "minLength" in schema and len(args) < schema["minLength"]:
            errors.append(f"{path}: shorter than minLength {schema['minLength']}")
        if "maxLength" in schema and len(args) > schema["maxLength"]:
            errors.append(f"{path}: longer than maxLength {schema['maxLength']}")
        if "pattern" in schema and not re.search(schema["pattern"], args):
            errors.append(f"{path}: does not match pattern {schema['pattern']!r}")
    if isinstance(args, (int, float)) and not isinstance(args, bool):
        if "minimum" in schema and args < schema["minimum"]:
            errors.append(f"{path}: {args} < minimum {schema['minimum']}")
        if "maximum" in schema and args > schema["maximum"]:
            errors.append(f"{path}: {args} > maximum {schema['maximum']}")
    if isinstance(args, dict):
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in args:
                errors.append(f"{path or 'object'}: missing required property {req!r}")
        for key, val in args.items():
            if key in props:
                errors.extend(validate_schema(val, props[key], f"{path}.{key}" if path else key))
            elif schema.get("additionalProperties") is False:
                errors.append(f"{path or 'object'}: unexpected property {key!r}")
    if isinstance(args, list) and "items" in schema:
        for i, item in enumerate(args):
            errors.extend(validate_schema(item, schema["items"], f"{path}[{i}]"))
    return errors


@dataclass
class Tool:
    """A registered tool: JSON-schema declaration + Python handler."""

    name: str
    description: str
    input_schema: dict
    handler: Callable[..., Any]
    tags: tuple[str, ...] = ()

    def validate_arguments(self, args: dict) -> list[str]:
        return validate_schema(args, self.input_schema)

    def to_schema(self) -> dict:
        """Anthropic-style tool declaration (name/description/input_schema)."""
        return {
            "name": self.name,
            "description": self.description,
            "input_schema": self.input_schema,
        }

    def to_openai_schema(self) -> dict:
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": self.input_schema,
            },
        }


class ToolRegistry:
    """Thread-safe name→Tool map with validated dispatch.

    Parity with fei/tools/registry.py:156-607; MCP tools are handled by a
    pluggable ``mcp_dispatcher`` rather than a hardcoded special case.
    """

    def __init__(self, max_workers: int = 10):
        self._tools: dict[str, Tool] = {}
        self._lock = threading.RLock()
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="tool")
        self.mcp_dispatcher: Callable[[str, dict], Any] | None = None

    def register_tool(
        self,
        name: str,
        description: str,
        input_schema: dict,
        handler: Callable[..., Any],
        tags: tuple[str, ...] = (),
    ) -> Tool:
        tool = Tool(name, description, input_schema, handler, tags)
        with self._lock:
            if name in self._tools:
                log.debug("re-registering tool %s", name)
            self._tools[name] = tool
        return tool

    def register(self, definition: dict, handler: Callable[..., Any]) -> Tool:
        """Register from a definitions.py-style dict."""
        return self.register_tool(
            definition["name"], definition["description"], definition["input_schema"], handler
        )

    def unregister(self, name: str) -> bool:
        with self._lock:
            return self._tools.pop(name, None) is not None

    def get_tool(self, name: str) -> Tool | None:
        with self._lock:
            return self._tools.get(name)

    def list_tools(self) -> list[str]:
        with self._lock:
            return sorted(self._tools)

    def get_schemas(self, format: str = "anthropic") -> list[dict]:
        with self._lock:
            tools = list(self._tools.values())
        if format == "openai":
            return [t.to_openai_schema() for t in tools]
        return [t.to_schema() for t in tools]

    # -- dispatch ------------------------------------------------------------

    def execute_tool(self, name: str, args: dict | None = None) -> Any:
        """Validate and run a tool; tool errors come back as {"error": ...}.

        Mirrors the reference contract (fei/tools/registry.py:250-297): errors
        during *execution* are returned as error payloads (so the agent loop
        can feed them back to the model), while unknown tools and invalid
        arguments raise typed errors.
        """
        args = args or {}
        if name.startswith("mcp_") and self.mcp_dispatcher is not None and name not in self._tools:
            return self.mcp_dispatcher(name, args)
        tool = self.get_tool(name)
        if tool is None:
            raise ToolNotFoundError(f"unknown tool: {name}")
        errors = tool.validate_arguments(args)
        if errors:
            raise ToolValidationError(f"invalid arguments for {name}: " + "; ".join(errors))
        METRICS.incr("tool.calls")
        with METRICS.span(f"tool.{name}"):
            try:
                result = tool.handler(**args)
                if inspect.iscoroutine(result):
                    result = self._run_coroutine(result)
                return result
            except ToolError:
                METRICS.incr("tool.errors")
                raise
            except Exception as exc:  # noqa: BLE001 — surfaced to the model
                METRICS.incr("tool.errors")
                log.warning("tool %s failed: %s", name, exc)
                return {"error": f"{type(exc).__name__}: {exc}"}

    async def execute_tool_async(self, name: str, args: dict | None = None) -> Any:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._pool, self.execute_tool, name, args)

    def _run_coroutine(self, coro) -> Any:
        """Run a coroutine from sync context without nesting event loops."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(coro)
        # Called from inside a loop: run in a dedicated thread's fresh loop.
        fut = self._pool.submit(asyncio.run, coro)
        return fut.result()

    # -- reflection ----------------------------------------------------------

    def register_class_methods(
        self, instance: Any, prefix: str = "", include: list[str] | None = None
    ) -> list[str]:
        """Register public methods of ``instance`` as tools, deriving a JSON
        schema from each signature (parity: fei/tools/registry.py:503-584)."""
        registered = []
        for attr in dir(instance):
            if attr.startswith("_"):
                continue
            if include is not None and attr not in include:
                continue
            fn = getattr(instance, attr)
            if not callable(fn):
                continue
            name = f"{prefix}{attr}"
            self.register_tool(name, inspect.getdoc(fn) or name, _signature_schema(fn), fn)
            registered.append(name)
        return registered


def _signature_schema(fn: Callable) -> dict:
    """Derive a JSON schema from a function signature's annotations."""
    py_to_json = {str: "string", int: "integer", float: "number", bool: "boolean",
                  list: "array", dict: "object"}
    props: dict[str, dict] = {}
    required: list[str] = []
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return {"type": "object", "properties": {}}
    for pname, param in sig.parameters.items():
        if pname in ("self", "cls") or param.kind in (
            inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD
        ):
            continue
        ann = param.annotation
        jtype = py_to_json.get(ann, "string")
        props[pname] = {"type": jtype}
        if param.default is inspect.Parameter.empty:
            required.append(pname)
    schema: dict = {"type": "object", "properties": props}
    if required:
        schema["required"] = required
    return schema
