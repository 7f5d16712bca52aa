"""Continuous task execution: iterate the agent until it signals completion.

Parity with the reference's TaskExecutor (fei/core/task_executor.py:23-316):
the task prompt instructs the model to end with ``[TASK_COMPLETE]``; each
iteration runs a full Assistant.chat turn and the loop stops on the signal,
the iteration cap, or an error. Conversation state is shared across
iterations (context grows — the engine's long-context path serves this).

A copy of ``fei_tpu/agent/task_executor.py`` that imports only the port.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from fei_tpu_torch.agent.assistant import Assistant
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("agent.task_executor")

COMPLETION_SIGNAL = "[TASK_COMPLETE]"

TASK_PROMPT_TEMPLATE = (
    "You are executing a multi-step task. Work step by step, using tools as "
    "needed. When — and only when — the entire task is finished, end your "
    "message with the exact marker {signal}.\n\nTASK:\n{task}"
)

CONTINUE_PROMPT = (
    "Continue with the next step of the task. Remember to end with "
    f"{COMPLETION_SIGNAL} only when the whole task is done."
)


@dataclass
class TaskContext:
    task: str
    iterations: int = 0
    completed: bool = False
    duration_s: float = 0.0
    responses: list[str] = field(default_factory=list)

    @property
    def final_response(self) -> str:
        return self.responses[-1] if self.responses else ""


class TaskExecutor:
    def __init__(self, assistant: Assistant, max_iterations: int = 10,
                 iteration_delay_s: float = 0.0):
        self.assistant = assistant
        self.max_iterations = max_iterations
        self.iteration_delay_s = iteration_delay_s

    def _process_response(self, ctx: TaskContext, response: str) -> str:
        """Record a response; detect and strip the completion signal.

        The signal only counts when it ENDS the response, as the protocol
        prompt instructs — a model merely restating its instructions
        mid-text must not terminate the task."""
        if response is None:
            response = ""
        if not response.strip():
            outputs = self.assistant.conversation.last_tool_outputs(1)
            if outputs:
                response = outputs[-1]
        if response.rstrip().endswith(COMPLETION_SIGNAL):
            ctx.completed = True
            response = response.rstrip()[: -len(COMPLETION_SIGNAL)].strip()
        ctx.responses.append(response)
        return response

    async def execute_task(self, task: str, system_prompt: str | None = None) -> TaskContext:
        return await self.execute_interactive(
            task, confirm=lambda ctx, resp: True, system_prompt=system_prompt
        )

    async def execute_interactive(self, task: str, confirm, system_prompt=None) -> TaskContext:
        """Run the iteration loop, calling ``confirm(ctx, response) -> bool``
        between iterations; False stops the loop (parity:
        fei/core/task_executor.py:262). execute_task is the
        confirm-always-True case."""
        ctx = TaskContext(task=task)
        t0 = time.perf_counter()
        prompt = TASK_PROMPT_TEMPLATE.format(signal=COMPLETION_SIGNAL, task=task)
        while ctx.iterations < self.max_iterations:
            ctx.iterations += 1
            response = await self.assistant.chat(prompt, system_prompt)
            shown = self._process_response(ctx, response)
            if ctx.completed:
                break
            if not confirm(ctx, shown):
                break
            prompt = CONTINUE_PROMPT
            if self.iteration_delay_s:
                await asyncio.sleep(self.iteration_delay_s)
        ctx.duration_s = time.perf_counter() - t0
        if not ctx.completed:
            log.warning("task stopped after %d iteration(s) without %s",
                        ctx.iterations, COMPLETION_SIGNAL)
        return ctx
