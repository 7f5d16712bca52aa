"""Pluggable node-to-node transport for Memorychain.

The reference hardwires synchronous HTTP JSON between nodes
(memdir_tools/memorychain.py:975-1035); here the chain takes a Transport so
the same consensus logic runs over:

- ``HTTPTransport`` — urllib JSON POSTs to peer node servers (cross-host /
  DCN federation, reference-equivalent);
- ``LoopbackTransport`` — an in-process registry of chains, giving the
  hermetic multi-node tests the reference lacks (SURVEY.md §4);
- the TPU sub-mesh federation (federation.py) exchanges memory *embeddings*
  over ICI collectives and uses one of the above only for control-plane
  membership.

A copy of ``fei_tpu/memory/memorychain/transport.py`` that imports only the port.
"""

from __future__ import annotations

import json
import urllib.request

from fei_tpu_torch.utils.logging import get_logger

log = get_logger("memory.transport")


class Transport:
    def request_vote(self, peer: str, proposal: dict) -> bool:
        raise NotImplementedError

    def push_chain(self, peer: str, blocks: list[dict]) -> bool:
        raise NotImplementedError

    def fetch_chain(self, peer: str) -> list[dict]:
        raise NotImplementedError


class LoopbackTransport(Transport):
    """Registry of in-process chains keyed by address string."""

    def __init__(self):
        self.nodes: dict[str, object] = {}  # address → MemoryChain

    def register(self, address: str, chain) -> None:
        self.nodes[address] = chain

    def request_vote(self, peer: str, proposal: dict) -> bool:
        chain = self.nodes.get(peer)
        if chain is None:
            raise ConnectionError(f"no loopback node {peer}")
        return chain.vote_on_proposal(proposal)

    def push_chain(self, peer: str, blocks: list[dict]) -> bool:
        chain = self.nodes.get(peer)
        if chain is None:
            raise ConnectionError(f"no loopback node {peer}")
        return chain.receive_chain_update(blocks)

    def fetch_chain(self, peer: str) -> list[dict]:
        chain = self.nodes.get(peer)
        if chain is None:
            raise ConnectionError(f"no loopback node {peer}")
        return [b.to_dict() for b in chain.blocks]


class HTTPTransport(Transport):
    """JSON POST/GET against MemorychainNode HTTP servers (node.py)."""

    def __init__(self, timeout: float = 10.0):
        self.timeout = timeout

    def _post(self, url: str, payload: dict | list) -> dict:
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def _get(self, url: str) -> dict:
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def request_vote(self, peer: str, proposal: dict) -> bool:
        out = self._post(f"{peer}/memorychain/vote", proposal)
        return bool(out.get("vote"))

    def push_chain(self, peer: str, blocks: list[dict]) -> bool:
        out = self._post(f"{peer}/memorychain/update", {"chain": blocks})
        return bool(out.get("adopted"))

    def fetch_chain(self, peer: str) -> list[dict]:
        return self._get(f"{peer}/memorychain/chain").get("chain", [])
