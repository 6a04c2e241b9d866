"""rtap_tpu_torch.resilience — retry/circuit-breaker policies for the serve
stack's IO edges (resilience/policies.py) and the per-tick write-ahead
journal (resilience/journal.py). Chaos, degradation, supervision and
replication are not ported yet."""
