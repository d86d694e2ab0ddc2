"""The port's ``hash_count_file`` end to end against the JAX package's.

Both drivers read the same files; the port runs on the CPU (its kernels'
plain versions), JAX on the CPU with Pallas in interpret mode.  All four
outputs must be equal, and at k=21 they must be the corpus goldens.  Also:
checkpoints resume across packages, a JAX limb state carries into the
port, the CLIs print the same JSON, and the port runs where JAX cannot be
imported.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from needletail_tpu.device import pipeline as jpipe
from needletail_tpu.parallel import distributed as jdist
from needletail_tpu.utils.profiling import ThroughputMeter
from needletail_tpu_torch.device import pipeline as tpipe
from needletail_tpu_torch.io import framing

REPO = Path(__file__).resolve().parent.parent
FQ = "tests/data/PRJNA271013_head.fq"
GOLD = (250_000, 209_965, 106_181)  # bases, windows, forward at k=21
RUN = dict(batch_size=512, max_len=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel worker processes; torch's intra-op pool
    in each of them would oversubscribe the cores, so these tests run the
    port's CPU path on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX results on the corpus, by (k, packed)."""
    return {
        (k, packed): jpipe.hash_count_file(
            FQ, k, host_workers=1, packed=packed, **RUN
        )
        for k in (21, 9)
        for packed in (True, False)
    }


@pytest.fixture(scope="module")
def corpus2(tmp_path_factory):
    """The corpus written twice: 8 batches of 512 reads."""
    p = tmp_path_factory.mktemp("torch_ckpt") / "reads.fq"
    p.write_bytes(Path(FQ).read_bytes() * 2)
    return str(p)


@pytest.fixture(scope="module")
def corpus2_ref(corpus2, jax_ref):
    """The port's uninterrupted run over ``corpus2``: twice the JAX
    one-copy result."""
    ref = tpipe.hash_count_file(corpus2, 21, host_workers=1, device="cpu", **RUN)
    one = jax_ref[(21, True)]
    assert ref[:3] == tuple(2 * int(x) for x in one[:3])
    np.testing.assert_array_equal(ref[3], 2 * np.asarray(one[3]))
    return ref


def _equal(got, want):
    assert got[:3] == tuple(int(x) for x in want[:3])
    assert got[3].dtype == np.int64
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))


@pytest.mark.parametrize(
    "k,packed,double_buffer,host_workers",
    [
        (21, True, True, 1),
        (21, False, True, 1),
        (21, True, False, 1),
        (21, False, False, 1),
        (9, True, True, 1),
        (9, False, False, 1),
        (21, True, True, 2),
        (9, False, True, 2),
    ],
)
def test_hash_count_file_matches_jax(
    jax_ref, k, packed, double_buffer, host_workers
):
    got = tpipe.hash_count_file(
        FQ, k, packed=packed, double_buffer=double_buffer,
        host_workers=host_workers, device="cpu", **RUN,
    )
    _equal(got, jax_ref[(k, packed)])
    if k == 21:
        assert got[:3] == GOLD


def test_list_of_paths_accumulates_like_jax(jax_ref):
    got = tpipe.hash_count_file([FQ, FQ], 21, host_workers=1, device="cpu", **RUN)
    one = jax_ref[(21, True)]
    assert got[:3] == tuple(2 * x for x in GOLD)
    np.testing.assert_array_equal(got[3], 2 * np.asarray(one[3]))


def test_meter_records_every_stage(jax_ref):
    meter = ThroughputMeter()
    got = tpipe.hash_count_file(
        FQ, 21, host_workers=1, meter=meter, device="cpu", **RUN
    )
    _equal(got, jax_ref[(21, True)])
    stages = meter.as_dict()
    assert {"frame", "h2d", "wait", "dispatch", "drain", "wall"} <= set(stages)
    assert stages["wall"]["items"] == GOLD[0]
    assert stages["h2d"]["bytes"] == stages["frame"]["bytes"] > 0


@pytest.mark.parametrize("packed", [True, False])
def test_max_len_below_k_skips_batches(tmp_path, packed):
    """Batches narrower than k hold no window: their bases count, no step
    runs."""
    p = tmp_path / "short.fq"
    p.write_bytes(b"@a\nACGTACGTACGTAC\n+\nIIIIIIIIIIIIII\n" * 40)
    kw = dict(batch_size=16, max_len=16, host_workers=1, packed=packed)
    got = tpipe.hash_count_file(str(p), 21, device="cpu", **kw)
    _equal(got, jpipe.hash_count_file(str(p), 21, **kw))
    assert got[:3] == (40 * 14, 0, 0) and not got[3].any()


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.hash_count_file(FQ, 21, device="cuda", **RUN)


class _Interrupt(Exception):
    pass


class _StopAfter:
    """A meter that stops a driver at its n-th step, as a kill would."""

    def __init__(self, n):
        self.n = n
        self.steps = 0

    def add(self, name, seconds, nbytes=0, items=0):
        if name == "dispatch":
            self.steps += 1
            if self.steps == self.n:
                raise _Interrupt


def _interrupted(driver, corpus, ck, **kw):
    with pytest.raises(_Interrupt):
        driver(
            corpus, 21, checkpoint_every=1, checkpoint_path=ck,
            host_workers=1, meter=_StopAfter(4), **kw, **RUN,
        )


def test_jax_checkpoint_resumes_in_port(corpus2, corpus2_ref, tmp_path):
    ref = corpus2_ref
    ck = str(tmp_path / "jax.npz")
    _interrupted(jpipe.hash_count_file, corpus2, ck)
    got = tpipe.hash_count_file(
        corpus2, 21, resume_from=ck, host_workers=1, device="cpu", **RUN
    )
    _equal(got, ref)
    assert got[:3] == tuple(2 * x for x in GOLD)


def test_port_checkpoint_resumes_in_jax(corpus2, corpus2_ref, tmp_path):
    ref = corpus2_ref
    ck = str(tmp_path / "torch.npz")
    _interrupted(tpipe.hash_count_file, corpus2, ck, device="cpu")
    from needletail_tpu.parallel.checkpoint import load_stream_checkpoint

    saved = load_stream_checkpoint(ck)
    assert saved["kind"] == "hash" and saved["k"] == 21
    assert 0 < saved["file_offset"] < os.path.getsize(corpus2)
    got = jpipe.hash_count_file(
        corpus2, 21, resume_from=ck, host_workers=1, **RUN
    )
    _equal(ref, got)


def test_checkpoint_files_share_keys(tmp_path):
    from needletail_tpu.parallel import checkpoint as jck
    from needletail_tpu_torch import checkpoint as tck

    kw = dict(
        arrays={"table": np.arange(16, dtype=np.int64) << 33},
        input_path="x.fq",
        meta={"table_bits": np.int32(4), **tck.counting_meta(normalized=False)},
    )
    tck.save_stream_checkpoint(tmp_path / "t.npz", "hash", 9, 77, 1234, **kw)
    jck.save_stream_checkpoint(tmp_path / "j.npz", "hash", 9, 77, 1234, **kw)
    for reader in (tck.load_stream_checkpoint, jck.load_stream_checkpoint):
        a = reader(tmp_path / "t.npz")
        b = reader(tmp_path / "j.npz")
        assert a.keys() == b.keys()
        assert set(a["meta"]) == set(b["meta"])
        for key in ("kind", "k", "file_offset", "n_bases", "input_path"):
            assert a[key] == b[key]
        np.testing.assert_array_equal(a["arrays"]["table"], b["arrays"]["table"])


def test_resume_refuses_other_semantics(corpus2, tmp_path):
    ck = str(tmp_path / "n.npz")
    _interrupted(tpipe.hash_count_file, corpus2, ck, device="cpu")
    with pytest.raises(ValueError, match="normalized"):
        tpipe.hash_count_file(corpus2, 21, resume_from=ck, host_workers=1,
                              normalized=False, device="cpu", **RUN)
    with pytest.raises(ValueError, match="kind=hash"):
        tpipe.hash_count_file(corpus2, 9, resume_from=ck, host_workers=1,
                              device="cpu", **RUN)
    with pytest.raises(ValueError, match="host_workers"):
        tpipe.hash_count_file(corpus2, 21, resume_from=ck, host_workers=2,
                              device="cpu", **RUN)


def test_jax_limb_state_carries_into_port():
    """A JAX step's (table_lo, table_hi) limbs become the port's int64
    table, and the port's table splits back into the same limbs."""
    import jax.numpy as jnp

    from needletail_tpu.io.fast_batch import fast_read_batches
    from needletail_tpu.utils.limbs import limbs_to_int64_array as j_to64
    from needletail_tpu_torch.utils import limbs

    (batch,) = fast_read_batches(FQ, batch_size=2000, max_len=128, packed=True)
    buf, layout = batch.wire_frame(2048)
    jstep = jpipe._hash_step_fn(21, 16, True, True)
    lo = jnp.zeros(1 << 16, jnp.uint32)
    hi = jnp.zeros(1 << 16, jnp.uint32)
    tallies = jnp.zeros(4, jnp.uint32)
    lo, hi, tallies = jstep(lo, hi, tallies, jnp.asarray(buf), layout=layout)

    table = torch.zeros(1 << 16, dtype=torch.int64)
    ttallies = torch.zeros(2, dtype=torch.int64)
    tpipe._hash_step_fn(21, 16, True, True)(
        table, ttallies, torch.from_numpy(buf), layout
    )
    carried = limbs.limbs_to_int64_array(np.asarray(lo), np.asarray(hi))
    assert carried.dtype == torch.int64
    assert torch.equal(carried, table)
    back_lo, back_hi = limbs.int64_array_to_limbs(table)
    np.testing.assert_array_equal(back_lo, np.asarray(lo))
    np.testing.assert_array_equal(back_hi, np.asarray(hi))
    t = np.asarray(tallies)
    assert ttallies.tolist() == [
        int(t[0]) + (int(t[1]) << 32), int(t[2]) + (int(t[3]) << 32)
    ]
    # bins past 2^32 round-trip through both packages' limb helpers
    big = np.array([0, 1, (1 << 32) + 5, (7 << 40) + 123], dtype=np.int64)
    blo, bhi = limbs.int64_array_to_limbs(torch.from_numpy(big))
    np.testing.assert_array_equal(np.asarray(j_to64(blo, bhi)), big)
    assert limbs.limbs_to_int64_array(blo, bhi).tolist() == big.tolist()


def test_cli_json_matches_jax(capsys):
    from needletail_tpu import cli as jcli
    from needletail_tpu_torch import cli as tcli

    args = ["hash-count", FQ, "-k", "21", "--batch-size", "512",
            "--host-workers", "1"]
    assert tcli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want
    assert (got["bases"], got["windows"], got["forward"]) == GOLD


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_split_fastx_ranges_matches_jax(corpus2, n):
    assert framing.split_fastx_ranges(corpus2, n) == jdist.split_fastx_ranges(
        corpus2, n
    )


def test_runs_where_jax_cannot_be_imported(tmp_path):
    code = f"""
import sys
sys.modules["jax"] = None
from needletail_tpu_torch.device.pipeline import hash_count_file
gold = {GOLD!r}
r = hash_count_file({FQ!r}, 21, batch_size=512, max_len=128,
                    device="cpu", host_workers=2)
assert r[:3] == gold, r[:3]
c = hash_count_file({FQ!r}, 21, batch_size=512, max_len=128, device="cpu",
                    host_workers=1, checkpoint_every=1,
                    checkpoint_path={str(tmp_path / "ck.npz")!r})
assert c[:3] == gold, c[:3]
assert (r[3] == c[3]).all()
loaded = [m for m, v in sys.modules.items()
          if v is not None and (m == "jax" or m.startswith(("jax.", "jaxlib")))]
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_port_imports_no_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    files = sorted((REPO / "needletail_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 5
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
