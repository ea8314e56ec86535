"""The share of the orient contractions' window samples that belong to
valid lanes: ``orient.samples_valid`` over ``orient.samples_computed``
(each radius class padded to whole lane chunks), the program's counters
(``sift_tpu_torch.utils.profiling.counters``) over the traced run's
profiler window."""


def read(run):
    if run.trace is None:
        return None
    from sift_tpu_torch.utils import profiling

    c = profiling.counters() if hasattr(profiling, "counters") else {}
    if not c.get("orient.samples_computed"):
        return None
    return 100.0 * c["orient.samples_valid"] / c["orient.samples_computed"]
