"""Host-side drain-style log-template miner (the log-template encoder family).

The port's copy of the JAX package's ``ingest/templates.py``: pure Python,
the same masks, similarity rule and id order.

The log-template encoder of "Encoding Data for HTM Systems" needs a
stable line -> template-id map: the HTM sees the TEMPLATE (the fixed
part of a log line) as a categorical field, while the variable parts
(ids, counts, addresses) are masked out. This is the Drain algorithm's
fixed-depth parse tree, compacted for the ingest boundary:

1. tokenize on whitespace; tokens containing digits mask to ``<*>``
   up front (Drain's preprocessing — variables are overwhelmingly
   numeric-ish);
2. group by token COUNT, then descend a fixed-depth prefix tree keyed
   by the first ``depth`` masked tokens (wildcards collapse);
3. inside a leaf, match against existing templates by token-equality
   similarity; >= ``sim_threshold`` merges (differing tokens become
   ``<*>``), below it mints a new template id.

Ids are dense ints in FIRST-SEEN order, so a replayed line sequence
reproduces the same ids — the determinism the journal/crash story
needs. The miner is bounded: beyond ``max_templates`` new structures
fold into the OVERFLOW id (counted, never dropped silently), keeping a
hostile/log4j-ish firehose from growing host memory without bound.

The miner runs at the ingest boundary (lines in, template-id floats
out via :meth:`encode_values`); everything downstream — journal,
scoring, replay — sees only the numeric id stream, so the wire/replay
bit-exactness contracts are untouched by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["TemplateMiner", "WILDCARD"]

WILDCARD = "<*>"


def _mask(token: str) -> str:
    """Drain preprocessing: any token carrying a digit is a variable."""
    return WILDCARD if any(ch.isdigit() for ch in token) else token


@dataclass
class _Template:
    tid: int
    tokens: list[str]
    count: int = 0


@dataclass
class TemplateMiner:
    """Stable log-line -> template-id mapping (see module docstring).

    ``observe(line)`` returns the line's template id (minting one for a
    new structure); ``template(tid)`` renders the learned template
    string. ``encode_values`` is the ingest-boundary adapter: lines in,
    float ids out, ready to feed a categorical composite field.
    """

    depth: int = 4
    sim_threshold: float = 0.5
    max_templates: int = 4096

    _templates: list[_Template] = field(default_factory=list)
    #: prefix-tree: (token_count, tok0..tokD) -> list of template indices
    _tree: dict[tuple, list[int]] = field(default_factory=dict)
    #: lines that fell into the overflow bucket (capacity exhausted)
    overflow: int = 0
    lines_seen: int = 0

    def __post_init__(self) -> None:
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1; got {self.depth}")
        if not 0.0 < self.sim_threshold <= 1.0:
            raise ValueError(
                f"sim_threshold must be in (0, 1]; got {self.sim_threshold}")
        if self.max_templates < 2:
            raise ValueError(
                f"max_templates must be >= 2 (one id is the overflow "
                f"bucket); got {self.max_templates}")

    # ---- core ----
    @property
    def overflow_id(self) -> int:
        """The id every beyond-capacity structure folds into."""
        return self.max_templates - 1

    def n_templates(self) -> int:
        return len(self._templates)

    def observe(self, line: str) -> int:
        """Mine one line -> its (possibly fresh) template id."""
        self.lines_seen += 1
        tokens = [_mask(t) for t in line.split()]
        if not tokens:
            tokens = [WILDCARD]
        key = (len(tokens),
               *(tokens[i] if i < len(tokens) else "" for i in range(self.depth)))
        leaf = self._tree.get(key)
        if leaf is None:
            leaf = self._tree[key] = []
        best, best_sim = None, -1.0
        for ti in leaf:
            t = self._templates[ti]
            same = sum(1 for a, b in zip(t.tokens, tokens) if a == b)
            sim = same / len(tokens)
            if sim > best_sim:
                best, best_sim = t, sim
        if best is not None and best_sim >= self.sim_threshold:
            # merge: positions that disagree become wildcards (the
            # template generalizes as variable positions reveal themselves)
            best.tokens = [a if a == b else WILDCARD
                           for a, b in zip(best.tokens, tokens)]
            best.count += 1
            return best.tid
        if len(self._templates) >= self.max_templates - 1:
            # capacity: fold into the overflow bucket, loudly countable —
            # an unbounded template population is an attack shape, not a
            # workload (docs/WORKLOADS.md sizing note)
            self.overflow += 1
            return self.overflow_id
        t = _Template(tid=len(self._templates), tokens=list(tokens), count=1)
        self._templates.append(t)
        leaf.append(t.tid)
        return t.tid

    def template(self, tid: int) -> str:
        """Render a learned template (the overflow id renders as such)."""
        if tid == self.overflow_id and tid >= len(self._templates):
            return "<overflow>"
        return " ".join(self._templates[tid].tokens)

    def encode_values(self, lines: list[str]) -> list[float]:
        """Ingest-boundary adapter: log lines -> template-id floats, ready
        to feed a categorical composite field (resolution 1.0: the id IS
        the bucket)."""
        return [float(self.observe(ln)) for ln in lines]

    def stats(self) -> dict:
        return {
            "templates": len(self._templates),
            "lines_seen": self.lines_seen,
            "overflow": self.overflow,
            "top": sorted(
                ({"tid": t.tid, "count": t.count,
                  "template": " ".join(t.tokens)}
                 for t in self._templates),
                key=lambda d: -d["count"])[:10],
        }
