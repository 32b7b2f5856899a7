"""Faults planted under the timed path, to show that the comparison
catches them. Each wraps a function with `bundle_adjust`'s signature
(problem, **settings) -> (problem, cost). On one chip there is no
exchange between chips to leave out."""

from __future__ import annotations


def unchanged(fn):
    """Every step returns its state unchanged: the start comes back."""
    def solve(p, **kw):
        return fn(p, **dict(kw, iters=0))
    return solve


def half_batch(fn):
    """Half of the observations left out, and the cost of the rest scaled
    to stand for the whole."""
    def solve(p, **kw):
        valid = p.obs_valid.clone()
        valid[1::2] = False
        q, c = fn(p._replace(obs_valid=valid), **kw)
        return q._replace(obs_valid=p.obs_valid), 2.0 * c
    return solve


def altered(fn):
    """One answer altered where it is produced: point 0 moved by 0.5 m
    (7 px or more in every image of it, at the map's 60 m at most)."""
    def solve(p, **kw):
        q, c = fn(p, **kw)
        pts = q.points.clone()
        pts[0, 0] += 0.5
        return q._replace(points=pts), c
    return solve


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
