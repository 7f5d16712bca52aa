"""Share of the prompt tokens admitted in the window that the prefix
cache served: 1 - (tokens prefilled) / (prompt tokens of the requests
whose first token came in the window)."""


def read(view):
    prompt = sum(len(r.prompt) for r in view.records
                 if r.stamps and view.w0 <= r.stamps[0] <= view.w1)
    if not prompt:
        return None
    return (1.0 - view.delta("scheduler.prefill_tokens") / prompt)
