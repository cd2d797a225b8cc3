"""The double-f32 engine's two descents on the same batches: ``descent=
"device"`` (the device's f32 descent as it ends) against ``descent="exact"``
(proved by its margin, or replayed on the host in f64).

The device descent may resolve an exact tie otherwise than the reference's
f64, so the two outputs are held equal only on the queries the exact run did
not replay on the host (its descent or a risk-band confidence); the others
are counted. ``chip_smoke.py`` runs this at 65,536 references on the card;
the GPU tests run it on a small world.
"""

from __future__ import annotations

from types import SimpleNamespace


def dd_args(device: str, batch: int, descent: str, fold: str = "sparse",
            split2: bool = True, split_sig: bool = False,
            bm_scan: bool = False) -> SimpleNamespace:
    """The parsed command line of a double-f32 run (``RAXTAX_EXACT=0``) with
    ``--descent descent`` and the engine's other choices."""
    return SimpleNamespace(
        backend="auto", device=device, batch_size=batch, debug_checks=True,
        tsv=True, skip_exact_matches=False, raw_confidence=False,
        significance="dd", fold=fold, split2=split2, split_sig=split_sig,
        bm_scan=bm_scan, descent=descent,
    )


def compare_descents(db, queries, batch: int, device: str, **mode) -> dict:
    """Both descents over ``queries`` in batches of ``batch``: the counts of
    queries compared, equal and replayed by the exact run, the labels that
    differ, and the host replays of each run (the device run's must be 0)."""
    from ..engine.classify import make_classifier

    exact = make_classifier(db, dd_args(device, batch, "exact", **mode))
    dev = make_classifier(db, dd_args(device, batch, "device", **mode))
    compared = equal = replayed = 0
    differ: list[str] = []
    for lo in range(0, len(queries), batch):
        chunk = queries[lo : lo + batch]
        want = exact.classify_batch(chunk)
        host = {chunk[i][0] for i in exact._replayed_queries}
        got = dev.classify_batch(chunk)
        for w, g in zip(want, got):
            if w.label in host:
                replayed += 1
                continue
            compared += 1
            if w.out_string() == g.out_string():
                equal += 1
            else:
                differ.append(w.label)
    return {
        "queries": len(queries), "compared": compared, "equal": equal,
        "replayed_by_exact": replayed, "differ": differ,
        "host_replays_exact": exact.host_replays,
        "host_replays_device": dev.host_replays,
    }
