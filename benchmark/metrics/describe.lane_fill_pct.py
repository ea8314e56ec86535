"""The share of the describe contractions' window samples that belong to
valid lanes: ``describe.samples_valid`` over ``describe.samples_computed``
(each radius class padded to whole lane chunks), the program's counters
(``sift_tpu_torch.utils.profiling.counters``) over the traced run's
profiler window."""


def read(run):
    if run.trace is None:
        return None
    from sift_tpu_torch.utils import profiling

    c = profiling.counters() if hasattr(profiling, "counters") else {}
    if not c.get("describe.samples_computed"):
        return None
    return 100.0 * c["describe.samples_valid"] / c["describe.samples_computed"]
