"""Memorychain: distributed memory/task ledger with consensus voting.

Capability parity with the reference's memdir_tools/memorychain.py:49-2023 —
hash-linked blocks with proof-of-work, 51 % quorum proposal voting, task
lifecycle (propose/claim/solve/vote) with FeiCoin rewards, longest-chain
sync — with the transport made pluggable: HTTP between hosts (the
reference's only mode), an in-process loopback for hermetic multi-node
tests, and a federation that exchanges memory embeddings on the card
(fei_tpu_torch.memory.memorychain.embedding_exchange, over
torch.distributed where there are several processes). A copy of
fei_tpu/memory/memorychain; chain files and block hashes are the JAX
package's bytes.
"""

from fei_tpu_torch.memory.memorychain.chain import (
    DIFFICULTY_REWARDS,
    TASK_STATES,
    FeiCoinWallet,
    MemoryBlock,
    MemoryChain,
)
from fei_tpu_torch.memory.memorychain.transport import (
    HTTPTransport,
    LoopbackTransport,
    Transport,
)

__all__ = [
    "DIFFICULTY_REWARDS",
    "FeiCoinWallet",
    "HTTPTransport",
    "LoopbackTransport",
    "MemoryBlock",
    "MemoryChain",
    "TASK_STATES",
    "Transport",
]
