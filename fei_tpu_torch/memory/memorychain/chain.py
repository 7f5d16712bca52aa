"""Chain core: blocks, proof-of-work, wallet, consensus ledger.

Behavior parity with the reference's memdir_tools/memorychain.py —
MemoryBlock hashing/mining (:110-143), task lifecycle helpers (:168-261),
FeiCoinWallet (:330-495), MemoryChain proposal consensus (:620-685), task
flow (:687-878), longest-valid-prefix-superset chain adoption (:1037-1085),
and JSON persistence (:1140-1172). Transport is injected (see transport.py)
instead of hardcoded HTTP.

A copy of ``fei_tpu/memory/memorychain/chain.py`` that imports only the port.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import asdict, dataclass, field

from fei_tpu_torch.utils.errors import MemoryError_
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("memory.memorychain")

DEFAULT_DIFFICULTY = 2  # leading zero hex digits of PoW (reference :501)
QUORUM = 0.51

TASK_STATES = ("proposed", "claimed", "solution_submitted", "completed", "rejected")

# task difficulty → FeiCoin reward (reference :66-72)
DIFFICULTY_REWARDS = {1: 5.0, 2: 10.0, 3: 25.0, 4: 50.0, 5: 100.0}

INITIAL_GRANT = 100.0  # reference :379


@dataclass
class MemoryBlock:
    index: int
    timestamp: float
    memory_id: str
    memory_data: dict
    previous_hash: str
    proposer_node: str = ""
    responsible_node: str = ""
    nonce: int = 0
    hash: str = ""
    # task fields (None for plain memories)
    is_task: bool = False
    task_state: str = ""
    task_difficulty: int = 1
    working_nodes: list = field(default_factory=list)
    solutions: list = field(default_factory=list)
    difficulty_votes: dict = field(default_factory=dict)

    def calculate_hash(self) -> str:
        payload = json.dumps(
            {
                "index": self.index,
                "timestamp": self.timestamp,
                "memory_id": self.memory_id,
                "memory_data": self.memory_data,
                "previous_hash": self.previous_hash,
                "proposer_node": self.proposer_node,
                "responsible_node": self.responsible_node,
                "is_task": self.is_task,
                "task_state": self.task_state,
                "task_difficulty": self.task_difficulty,
                "nonce": self.nonce,
            },
            sort_keys=True,
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def mine(self, difficulty: int = DEFAULT_DIFFICULTY) -> str:
        prefix = "0" * difficulty
        self.hash = self.calculate_hash()
        while not self.hash.startswith(prefix):
            self.nonce += 1
            self.hash = self.calculate_hash()
        return self.hash

    # -- task lifecycle (mutations re-hash via the owning chain) ------------

    def add_working_node(self, node_id: str) -> bool:
        if node_id in self.working_nodes:
            return False
        self.working_nodes.append(node_id)
        if self.task_state == "proposed":
            self.task_state = "claimed"
        return True

    def add_solution(self, node_id: str, solution: str) -> dict:
        entry = {
            "id": uuid.uuid4().hex[:8],
            "node": node_id,
            "solution": solution,
            "timestamp": time.time(),
            "votes": {},
        }
        self.solutions.append(entry)
        self.task_state = "solution_submitted"
        return entry

    def vote_on_difficulty(self, node_id: str, difficulty: int) -> int:
        """Record a vote; difficulty becomes the plurality choice
        (reference :216-261)."""
        self.difficulty_votes[node_id] = int(difficulty)
        counts: dict[int, int] = {}
        for v in self.difficulty_votes.values():
            counts[v] = counts.get(v, 0) + 1
        self.task_difficulty = max(sorted(counts), key=lambda d: counts[d])
        return self.task_difficulty

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MemoryBlock":
        known = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in known})


class FeiCoinWallet:
    """Per-node balances + transaction log, JSON-persisted."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.balances: dict[str, float] = {}
        self.transactions: list[dict] = []
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            try:
                with open(path) as fh:
                    data = json.load(fh)
                self.balances = data.get("balances", {})
                self.transactions = data.get("transactions", [])
            except (OSError, ValueError):
                log.warning("wallet file unreadable, starting fresh: %s", path)

    def _persist(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"balances": self.balances,
                       "transactions": self.transactions[-1000:]}, fh)
        os.replace(tmp, self.path)

    def balance(self, node_id: str) -> float:
        with self._lock:
            if node_id not in self.balances:
                self.balances[node_id] = INITIAL_GRANT
                self._record("grant", None, node_id, INITIAL_GRANT)
                self._persist()
            return self.balances[node_id]

    def add_funds(self, node_id: str, amount: float, reason: str = "reward") -> float:
        with self._lock:
            self.balances[node_id] = self.balances.get(node_id, INITIAL_GRANT) + amount
            self._record(reason, None, node_id, amount)
            self._persist()
            return self.balances[node_id]

    def transfer(self, src: str, dst: str, amount: float) -> bool:
        with self._lock:
            if self.balances.get(src, INITIAL_GRANT) < amount:
                return False
            self.balances[src] = self.balances.get(src, INITIAL_GRANT) - amount
            self.balances[dst] = self.balances.get(dst, INITIAL_GRANT) + amount
            self._record("transfer", src, dst, amount)
            self._persist()
            return True

    def _record(self, kind: str, src: str | None, dst: str, amount: float) -> None:
        self.transactions.append(
            {"kind": kind, "from": src, "to": dst, "amount": amount,
             "timestamp": time.time()}
        )

    def history(self, node_id: str) -> list[dict]:
        with self._lock:
            return [t for t in self.transactions
                    if t["to"] == node_id or t["from"] == node_id]


class MemoryChain:
    """The ledger one node maintains, with consensus over a Transport."""

    def __init__(
        self,
        node_id: str | None = None,
        base_dir: str | None = None,
        transport=None,
        difficulty: int = DEFAULT_DIFFICULTY,
    ):
        self.node_id = node_id or f"node-{uuid.uuid4().hex[:8]}"
        self.base_dir = base_dir or os.path.expanduser("~/.fei_tpu/memorychain")
        self.chain_path = os.path.join(self.base_dir, f"{self.node_id}.chain.json")
        self.transport = transport
        self.difficulty = difficulty
        self.peers: list[str] = []  # transport addresses of other nodes
        self.wallet = FeiCoinWallet(os.path.join(self.base_dir, f"{self.node_id}.wallet.json"))
        self._lock = threading.RLock()
        self.blocks: list[MemoryBlock] = []
        self._load()
        if not self.blocks:
            self._genesis()

    # -- persistence ---------------------------------------------------------

    def _genesis(self) -> None:
        block = MemoryBlock(
            index=0, timestamp=0.0, memory_id="genesis",
            memory_data={"content": "genesis"}, previous_hash="0" * 64,
        )
        block.mine(1)
        self.blocks = [block]
        self._persist()

    def _load(self) -> None:
        try:
            with open(self.chain_path) as fh:
                self.blocks = [MemoryBlock.from_dict(d) for d in json.load(fh)]
        except (OSError, ValueError):
            self.blocks = []

    def _persist(self) -> None:
        os.makedirs(self.base_dir, exist_ok=True)
        tmp = self.chain_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump([b.to_dict() for b in self.blocks], fh)
        os.replace(tmp, self.chain_path)

    # -- chain ops -----------------------------------------------------------

    @property
    def head(self) -> MemoryBlock:
        return self.blocks[-1]

    def add_block(self, memory_data: dict, memory_id: str | None = None,
                  responsible_node: str = "", **task_fields) -> MemoryBlock:
        with self._lock:
            block = MemoryBlock(
                index=len(self.blocks),
                timestamp=time.time(),
                memory_id=memory_id or uuid.uuid4().hex[:12],
                memory_data=memory_data,
                previous_hash=self.head.hash,
                proposer_node=self.node_id,
                responsible_node=responsible_node,
                **task_fields,
            )
            block.mine(self.difficulty)
            self.blocks.append(block)
            self._persist()
            return block

    def validate_chain(self, blocks: list[MemoryBlock] | None = None) -> bool:
        return _validate_blocks(blocks if blocks is not None else self.blocks)

    def get_block(self, memory_id: str) -> MemoryBlock | None:
        for block in self.blocks:
            if block.memory_id == memory_id:
                return block
        return None

    # -- consensus -----------------------------------------------------------

    def _gather_votes(self, proposal: dict) -> tuple[int, int]:
        """Ask every peer to vote; unreachable peers count as NO
        (reference :998-1001). Returns (yes, total_voters incl self)."""
        yes = 1  # self-vote
        total = 1 + len(self.peers)
        if not self.peers:
            return yes, total
        with ThreadPoolExecutor(max_workers=min(10, len(self.peers))) as pool:
            futures = {
                pool.submit(self.transport.request_vote, peer, proposal): peer
                for peer in self.peers
            }
            for fut in as_completed(futures):
                try:
                    if fut.result():
                        yes += 1
                except Exception:  # noqa: BLE001 — peer failure = no vote
                    pass
        return yes, total

    def vote_on_proposal(self, proposal: dict) -> bool:
        """Local validity check when a peer asks us to vote
        (reference :932-965)."""
        data = proposal.get("memory_data", {})
        if not isinstance(data, dict) or "content" not in data:
            return False
        if self.get_block(proposal.get("memory_id", "")) is not None:
            return False  # duplicate
        return True

    def propose_memory(self, memory_data: dict, is_task: bool = False,
                       difficulty: int = 1) -> MemoryBlock | None:
        """Propose → parallel votes → ≥51 % → mine+commit+broadcast.
        Responsible node is deterministic on the proposal id
        (reference :667-671)."""
        proposal_id = uuid.uuid4().hex[:12]
        proposal = {
            "proposal_id": proposal_id,
            "memory_id": proposal_id,
            "memory_data": memory_data,
            "proposer": self.node_id,
            "is_task": is_task,
        }
        self._save_proposal(proposal)
        yes, total = self._gather_votes(proposal)
        if yes / total < QUORUM:
            log.info("proposal %s rejected (%d/%d)", proposal_id, yes, total)
            return None
        members = sorted([self.node_id] + self.peers)
        responsible = members[
            int(hashlib.sha256(proposal_id.encode()).hexdigest(), 16) % len(members)
        ]
        task_fields = {}
        if is_task:
            task_fields = {"is_task": True, "task_state": "proposed",
                           "task_difficulty": difficulty}
        block = self.add_block(memory_data, proposal_id,
                               responsible_node=responsible, **task_fields)
        self._broadcast_chain()
        return block

    def _save_proposal(self, proposal: dict) -> None:
        pdir = os.path.join(self.base_dir, "proposals")
        os.makedirs(pdir, exist_ok=True)
        with open(os.path.join(pdir, f"{proposal['proposal_id']}.json"), "w") as fh:
            json.dump(proposal, fh)

    def _broadcast_chain(self) -> None:
        if not self.peers:
            return
        payload = [b.to_dict() for b in self.blocks]
        with ThreadPoolExecutor(max_workers=min(10, len(self.peers))) as pool:
            for peer in self.peers:
                pool.submit(self._push_chain, peer, payload)

    def _push_chain(self, peer: str, payload: list[dict]) -> None:
        try:
            self.transport.push_chain(peer, payload)
        except Exception as exc:  # noqa: BLE001 — fire-and-forget
            log.debug("chain push to %s failed: %s", peer, exc)

    def receive_chain_update(self, blocks_data: list[dict]) -> bool:
        """Adopt a longer valid chain whose prefix is a superset of ours
        (reference :1037-1085)."""
        incoming = [MemoryBlock.from_dict(d) for d in blocks_data]
        with self._lock:
            if len(incoming) <= len(self.blocks):
                return False
            if not self.validate_chain(incoming):
                return False
            for mine, theirs in zip(self.blocks, incoming):
                if mine.hash != theirs.hash:
                    return False
            self.blocks = incoming
            self._persist()
            return True

    # -- tasks ---------------------------------------------------------------

    def propose_task(self, description: str, difficulty: int = 1,
                     metadata: dict | None = None) -> MemoryBlock | None:
        data = {"content": description, "type": "task",
                "metadata": metadata or {}}
        return self.propose_memory(data, is_task=True, difficulty=difficulty)

    def claim_task(self, task_id: str, node_id: str | None = None) -> bool:
        with self._lock:
            block = self.get_block(task_id)
            if block is None or not block.is_task:
                return False
            if block.task_state not in ("proposed", "claimed"):
                return False
            changed = block.add_working_node(node_id or self.node_id)
            if changed:
                block.hash = block.calculate_hash()
                self._rehash_from(block.index + 1)
                self._persist()
                self._broadcast_chain()
            return changed

    def submit_solution(self, task_id: str, solution: str,
                        node_id: str | None = None) -> dict | None:
        with self._lock:
            block = self.get_block(task_id)
            if block is None or not block.is_task:
                return None
            if block.task_state not in ("claimed", "solution_submitted"):
                return None
            entry = block.add_solution(node_id or self.node_id, solution)
            block.hash = block.calculate_hash()
            self._rehash_from(block.index + 1)
            self._persist()
            self._broadcast_chain()
            return entry

    def vote_on_solution(self, task_id: str, solution_id: str, approve: bool,
                         voter: str | None = None) -> str:
        """Record a vote; quorum approve ⇒ completed + reward, quorum
        reject ⇒ solution dropped (reference :789-878). Returns the task
        state after the vote."""
        with self._lock:
            block = self.get_block(task_id)
            if block is None or not block.is_task:
                raise MemoryError_(f"no task {task_id}")
            entry = next((s for s in block.solutions if s["id"] == solution_id), None)
            if entry is None:
                raise MemoryError_(f"no solution {solution_id}")
            entry["votes"][voter or self.node_id] = bool(approve)
            total_voters = 1 + len(self.peers)
            approvals = sum(1 for v in entry["votes"].values() if v)
            rejections = sum(1 for v in entry["votes"].values() if not v)
            if approvals / total_voters >= QUORUM:
                block.task_state = "completed"
                reward = DIFFICULTY_REWARDS.get(block.task_difficulty, 5.0)
                self.wallet.add_funds(entry["node"], reward, "task_reward")
            elif rejections / total_voters >= QUORUM:
                block.solutions.remove(entry)
                block.task_state = "claimed" if block.working_nodes else "proposed"
            block.hash = block.calculate_hash()
            self._rehash_from(block.index + 1)
            self._persist()
            self._broadcast_chain()
            return block.task_state

    def vote_on_task_difficulty(self, task_id: str, difficulty: int,
                                voter: str | None = None) -> int:
        with self._lock:
            block = self.get_block(task_id)
            if block is None or not block.is_task:
                raise MemoryError_(f"no task {task_id}")
            result = block.vote_on_difficulty(voter or self.node_id, difficulty)
            block.hash = block.calculate_hash()
            self._rehash_from(block.index + 1)
            self._persist()
            return result

    def _rehash_from(self, start: int) -> None:
        """Task mutations change a mid-chain block's hash; relink+remine the
        suffix so validate_chain stays true (the reference mutates in place
        and leaves the chain transiently invalid — a FLAWS.md defect)."""
        for i in range(start, len(self.blocks)):
            self.blocks[i].previous_hash = self.blocks[i - 1].hash
            self.blocks[i].mine(self.difficulty)

    def list_tasks(self, state: str | None = None) -> list[MemoryBlock]:
        return [b for b in self.blocks
                if b.is_task and (state is None or b.task_state == state)]

    # -- membership ----------------------------------------------------------

    def register_peer(self, address: str) -> bool:
        with self._lock:
            if address in self.peers:
                return False
            self.peers.append(address)
            return True

    def responsible_memories(self, node_id: str | None = None) -> list[MemoryBlock]:
        nid = node_id or self.node_id
        return [b for b in self.blocks if b.responsible_node == nid]

    def stats(self) -> dict:
        tags: dict[str, int] = {}
        states: dict[str, int] = {}
        responsible: dict[str, int] = {}
        for b in self.blocks[1:]:
            for t in b.memory_data.get("tags", []):
                tags[t] = tags.get(t, 0) + 1
            if b.is_task:
                states[b.task_state] = states.get(b.task_state, 0) + 1
            if b.responsible_node:
                responsible[b.responsible_node] = responsible.get(b.responsible_node, 0) + 1
        return {
            "length": len(self.blocks),
            "tasks": states,
            "tags": tags,
            "responsible": responsible,
            "valid": self.validate_chain(),
        }


def _validate_blocks(blocks: list[MemoryBlock]) -> bool:
    """Hash linkage + recomputed-hash validation shared by
    MemoryChain.validate_chain and validate_block_dicts."""
    for i, block in enumerate(blocks):
        if block.hash != block.calculate_hash():
            return False
        if i > 0 and (block.previous_hash != blocks[i - 1].hash
                      or block.index != blocks[i - 1].index + 1):
            return False
    return True


def validate_block_dicts(chain: list[dict]) -> bool:
    """Validate a serialized chain without constructing a MemoryChain — the
    client-side fallback the reference's connector implements inline
    (fei/tools/memorychain_connector.py:543-576). Malformed block dicts make
    the chain invalid, not an exception — the input is untrusted."""
    try:
        blocks = [MemoryBlock.from_dict(d) for d in chain]
    except (TypeError, ValueError):
        return False
    return _validate_blocks(blocks)
