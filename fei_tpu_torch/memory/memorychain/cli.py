"""Memorychain operator CLI.

Parity with the reference's memdir_tools/memorychain_cli.py:44-991:
start/propose/list/view/responsible/status/network/validate plus task
commands (propose-task/tasks/claim/solve/vote-solution/vote-difficulty) and
wallet, against a node's HTTP API; node identity persists across runs.

A copy of ``fei_tpu/memory/memorychain/cli.py`` that imports only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.request
import uuid

DEFAULT_NODE = os.environ.get("MEMORYCHAIN_NODE", "http://127.0.0.1:6789")
NODE_ID_FILE = os.path.expanduser("~/.fei_tpu/node_id.txt")


def persistent_node_id() -> str:
    try:
        with open(NODE_ID_FILE) as fh:
            return fh.read().strip()
    except OSError:
        nid = f"node-{uuid.uuid4().hex[:8]}"
        os.makedirs(os.path.dirname(NODE_ID_FILE), exist_ok=True)
        with open(NODE_ID_FILE, "w") as fh:
            fh.write(nid)
        return nid


def _post(node: str, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"{node}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=15) as resp:
        return json.loads(resp.read())


def _get(node: str, path: str) -> dict:
    with urllib.request.urlopen(f"{node}{path}", timeout=15) as resp:
        return json.loads(resp.read())


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="memorychain", description="Memorychain operator CLI")
    p.add_argument("--node", default=DEFAULT_NODE, help="node address")
    sub = p.add_subparsers(dest="cmd", required=True)

    st = sub.add_parser("start", help="start a node in this process")
    st.add_argument("--port", type=int, default=6789)
    st.add_argument("--seed", default=None)
    st.add_argument("--base-dir", default=None)

    pr = sub.add_parser("propose", help="propose a memory")
    pr.add_argument("content")
    pr.add_argument("--tags", default="")

    sub.add_parser("chain", help="print the chain")
    sub.add_parser("validate", help="validate the chain")
    sub.add_parser("status", help="node status")
    sub.add_parser("network", help="network status")
    sub.add_parser("stats", help="chain statistics")

    rs = sub.add_parser("responsible", help="memories a node is responsible for")
    rs.add_argument("node_id", nargs="?", default=None)

    pt = sub.add_parser("propose-task", help="propose a task")
    pt.add_argument("description")
    pt.add_argument("--difficulty", type=int, default=1)

    tl = sub.add_parser("tasks", help="list tasks")
    tl.add_argument("--state", default=None)

    tv = sub.add_parser("task", help="view one task")
    tv.add_argument("task_id")

    cl = sub.add_parser("claim", help="claim a task")
    cl.add_argument("task_id")

    so = sub.add_parser("solve", help="submit a task solution")
    so.add_argument("task_id")
    so.add_argument("solution")

    vs = sub.add_parser("vote-solution", help="vote on a solution")
    vs.add_argument("task_id")
    vs.add_argument("solution_id")
    vs.add_argument("--reject", action="store_true")

    vd = sub.add_parser("vote-difficulty", help="vote on task difficulty")
    vd.add_argument("task_id")
    vd.add_argument("difficulty", type=int)

    wa = sub.add_parser("wallet", help="FeiCoin balance")
    wa.add_argument("node_id", nargs="?", default=None)

    cn = sub.add_parser("connect", help="tell the node to join via a seed")
    cn.add_argument("seed")

    args = p.parse_args(argv)
    nid = persistent_node_id()
    try:
        return _dispatch(args, nid)
    except urllib.error.URLError as exc:
        print(f"error: cannot reach node {args.node}: {exc}", file=sys.stderr)
        return 1


def _dispatch(args, nid: str) -> int:
    node = args.node
    if args.cmd == "start":
        from fei_tpu_torch.memory.memorychain.node import MemorychainNode

        n = MemorychainNode(nid, args.port, args.base_dir, seed=args.seed)
        print(f"node {n.chain.node_id} on {n.address}")
        n.serve_forever()
    elif args.cmd == "propose":
        data = {"content": args.content}
        if args.tags:
            data["tags"] = [t for t in args.tags.split(",") if t]
        out = _post(node, "/memorychain/propose", {"memory_data": data})
        print(json.dumps(out, indent=2))
    elif args.cmd == "chain":
        print(json.dumps(_get(node, "/memorychain/chain"), indent=2))
    elif args.cmd == "validate":
        out = _get(node, "/memorychain/chain")
        print("valid" if out.get("valid") else "INVALID")
        return 0 if out.get("valid") else 1
    elif args.cmd == "status":
        print(json.dumps(_get(node, "/memorychain/node_status"), indent=2))
    elif args.cmd == "network":
        print(json.dumps(_get(node, "/memorychain/network_status"), indent=2))
    elif args.cmd == "stats":
        print(json.dumps(_get(node, "/memorychain/stats"), indent=2))
    elif args.cmd == "responsible":
        out = _get(node, f"/memorychain/responsible/{args.node_id or nid}")
        print(json.dumps(out, indent=2))
    elif args.cmd == "propose-task":
        out = _post(node, "/memorychain/propose_task",
                    {"description": args.description, "difficulty": args.difficulty})
        print(json.dumps(out, indent=2))
    elif args.cmd == "tasks":
        suffix = f"?state={args.state}" if args.state else ""
        print(json.dumps(_get(node, f"/memorychain/tasks{suffix}"), indent=2))
    elif args.cmd == "task":
        print(json.dumps(_get(node, f"/memorychain/tasks/{args.task_id}"), indent=2))
    elif args.cmd == "claim":
        out = _post(node, "/memorychain/claim_task",
                    {"task_id": args.task_id, "node_id": nid})
        print(json.dumps(out, indent=2))
    elif args.cmd == "solve":
        out = _post(node, "/memorychain/submit_solution",
                    {"task_id": args.task_id, "solution": args.solution,
                     "node_id": nid})
        print(json.dumps(out, indent=2))
    elif args.cmd == "vote-solution":
        out = _post(node, "/memorychain/vote_solution",
                    {"task_id": args.task_id, "solution_id": args.solution_id,
                     "approve": not args.reject, "voter": nid})
        print(json.dumps(out, indent=2))
    elif args.cmd == "vote-difficulty":
        out = _post(node, "/memorychain/vote_difficulty",
                    {"task_id": args.task_id, "difficulty": args.difficulty,
                     "voter": nid})
        print(json.dumps(out, indent=2))
    elif args.cmd == "wallet":
        out = _get(node, f"/memorychain/wallet/{args.node_id or nid}")
        print(json.dumps(out, indent=2))
    elif args.cmd == "connect":
        out = _post(node, "/memorychain/register", {"address": args.seed})
        print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
