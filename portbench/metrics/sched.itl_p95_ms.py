"""The stream's stalls: 95th percentile of the gaps between consecutive
tokens of one request as the client receives them, over the gaps that
end inside the window. Tokens reach the client a decode scan at a time,
so the tail is a scan plus the admissions between two scans."""

from portbench.readers import nearest_rank


def read(view):
    gaps = [b - a for r in view.records for a, b in zip(r.stamps, r.stamps[1:])
            if view.w0 <= b <= view.w1]
    v = nearest_rank(gaps, 95)
    return None if v is None else v * 1e3
