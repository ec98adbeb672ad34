"""The port's copy of the schedule lowering yields the reference's
program array for array: every ``StageTables`` field of both coded
stages, the reduce-side assembly tables and the stage-3 permutations."""

import dataclasses

import numpy as np
import pytest

from repro.core.schedule import SCHEDULE_CACHE as REF_CACHE
from repro_torch.core.schedule import SCHEDULE_CACHE as PORT_CACHE

QK = [(2, 3), (3, 3), (2, 4), (4, 3), (3, 4)]


def _equal(a, b, path, seen):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        if id(a) in seen:
            return
        seen.add(id(a))
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name),
                   f"{path}.{f.name}", seen)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]", seen)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _equal(a[key], b[key], f"{path}[{key!r}]", seen)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("q,k", QK)
def test_program_matches_reference(q, k):
    K = q * k
    d = (k - 1) * 5
    ref = REF_CACHE.program(q, k, Q=K, d=d)
    port = PORT_CACHE.program(q, k, Q=K, d=d)
    _equal(ref, port, f"program({q},{k})", set())
    # the fields the stacked executor reads, named explicitly
    for stage in (1, 2):
        T, U = ref.stage_tables(stage), port.stage_tables(stage)
        for name in ("enc_src", "src_ok", "dec_src", "dec_mask", "dec_recv",
                     "a2a_send", "a2a_recv", "pp_send", "pp_recv"):
            np.testing.assert_array_equal(getattr(T, name),
                                          getattr(U, name))
        assert T.pp_perms == U.pp_perms and int(T.R) == int(U.R)
    for name in ("is_own", "own_slot", "s2_ord", "s3_off", "owned_jobs",
                 "stored_batches"):
        np.testing.assert_array_equal(getattr(ref, name), getattr(port, name))
    assert ref.s3_perms == port.s3_perms
