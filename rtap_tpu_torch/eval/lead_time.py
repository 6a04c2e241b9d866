"""Lead-time scoring of the predictive horizon against a cascade's ground
truth. The port's copy of the JAX package's
``eval/fault_eval.py::score_lead_time``."""

from __future__ import annotations


def score_lead_time(
    events: list[dict],
    onsets: dict[str, int],
    cascade_order: list[str],
    node_of=None,
) -> dict:
    """Score predictive-horizon events against cascade ground truth
    (``python -m rtap_tpu_torch.predict_eval`` runs it).

    ``events`` are the predictor's emitted dicts (``precursor`` /
    ``predicted_incident``, the JAX package's schemas) with ticks on the
    eval's replay clock; ``onsets`` maps node -> fault-onset tick;
    ``cascade_order`` lists the faulted nodes origin-first. A *page* is
    the first precursor on any cascade node, or the first
    predicted_incident whose blast radius touches one — a false
    precursor on a healthy service must not count as the win. The
    headline is ``lead_ticks_vs_second``: positive means the operator
    was paged BEFORE the second node fell over, i.e. while the cascade
    was still preventable — the reference's lead-time question asked of
    the prediction stream instead of the score stream."""
    if node_of is None:
        def node_of(s):
            return s.rsplit(".", 1)[0] if "." in s else s
    cascade = set(cascade_order)
    first_by_node: dict[str, int] = {}
    false_precursors = 0
    for ev in events:
        if ev.get("event") != "precursor":
            continue
        node = node_of(str(ev.get("stream")))
        t = int(ev["tick"])
        if node in cascade:
            first_by_node[node] = min(t, first_by_node.get(node, t))
        else:
            false_precursors += 1
    incident = next(
        (ev for ev in events if ev.get("event") == "predicted_incident"
         and cascade & set(ev.get("blast_radius", ()))), None)
    page_ticks = list(first_by_node.values())
    if incident is not None:
        page_ticks.append(int(incident["tick"]))
    page_tick = min(page_ticks) if page_ticks else None
    origin = cascade_order[0]
    second_onset = onsets[cascade_order[1]] if len(cascade_order) > 1 \
        else None
    radius = set(incident.get("blast_radius", ())) \
        if incident is not None else set()
    blast_covered = incident is not None and cascade <= radius
    return {
        "paged": page_tick is not None,
        "page_tick": page_tick,
        "origin_onset": int(onsets[origin]),
        "second_onset": int(second_onset) if second_onset is not None
        else None,
        "lead_ticks_vs_origin": int(onsets[origin] - page_tick)
        if page_tick is not None else None,
        "lead_ticks_vs_second": int(second_onset - page_tick)
        if page_tick is not None and second_onset is not None else None,
        "first_precursor_by_node": {
            n: int(t) for n, t in sorted(first_by_node.items())},
        "false_precursors": false_precursors,
        "predicted_incident": None if incident is None else {
            "incident_id": incident.get("alert_id"),
            "tick": int(incident["tick"]),
            "first_node": incident.get("first_node"),
            "blast_radius": sorted(radius),
        },
        "blast_covered": blast_covered,
        "win": bool(page_tick is not None and second_onset is not None
                    and page_tick < second_onset and blast_covered),
    }
