"""The smaller SDK-core modules of the port against the JAX package's: the
retry policy (`retries.py`), content hashes (`_utils/hash_utils.py`), the
HS256 tokens (`_utils/jwt_utils.py`), the remote traceback frames
(`_utils/traceback_utils.py`), the progress output (`_output.py`) and the
log backfill (`_logs.py`, against the JAX `supervisor` fixture). Message
bytes, digests and tokens are compared exactly."""

import io
import os
import time

import pytest

from modal_tpu import _logs as jlogs
from modal_tpu import _output as joutput
from modal_tpu import retries as jretries
from modal_tpu._utils import hash_utils as jhash
from modal_tpu._utils import jwt_utils as jjwt
from modal_tpu._utils import traceback_utils as jtb
from modal_tpu._utils.async_utils import synchronizer as jsync
from modal_tpu.client import _Client as JClient
from modal_tpu.proto import api_pb2 as japi
from modal_tpu_torch import _logs as tlogs
from modal_tpu_torch import _output as toutput
from modal_tpu_torch import client as tclient
from modal_tpu_torch import retries as tretries
from modal_tpu_torch._utils import async_utils as tasync
from modal_tpu_torch._utils import hash_utils as thash
from modal_tpu_torch._utils import jwt_utils as tjwt
from modal_tpu_torch._utils import traceback_utils as ttb
from modal_tpu_torch.exception import InvalidError


@pytest.mark.parametrize("kwargs", [
    {"max_retries": 3}, {"max_retries": 0, "backoff_coefficient": 1.0, "initial_delay": 0.0},
    {"max_retries": 10, "backoff_coefficient": 3.5, "initial_delay": 0.25, "max_delay": 7.0},
])
def test_retry_policy_bytes_and_delays_equal_jax(kwargs):
    policy, jpolicy = tretries.Retries(**kwargs).to_proto(), jretries.Retries(**kwargs).to_proto()
    assert policy.SerializeToString() == jpolicy.SerializeToString()
    manager, jmanager = tretries.RetryManager(policy), jretries.RetryManager(jpolicy)
    assert [manager.attempt_delay(n) for n in range(12)] == [jmanager.attempt_delay(n) for n in range(12)]
    assert 0.0 <= manager.attempt_delay(3, jitter=True) <= manager.attempt_delay(3)


@pytest.mark.parametrize("kwargs", [
    {"max_retries": 11}, {"max_retries": 1, "backoff_coefficient": 0.5}, {"max_retries": 1, "initial_delay": 61},
    {"max_retries": 1, "initial_delay": 30, "max_delay": 5},
])
def test_retry_policy_bounds(kwargs):
    with pytest.raises(InvalidError):
        tretries.Retries(**kwargs)


def test_hashes_equal_jax(tmp_path):
    data = os.urandom(3 * 65536 + 17)
    for fn in ("get_sha256_hex", "get_sha256_base64", "get_md5_base64"):
        assert getattr(thash, fn)(data) == getattr(jhash, fn)(data)
        assert getattr(thash, fn)(io.BytesIO(data)) == getattr(jhash, fn)(io.BytesIO(data))
    segments = [data[:100], memoryview(data)[100:]]
    assert vars(thash.get_upload_hashes(segments)) == vars(jhash.get_upload_hashes(segments))
    assert thash.get_blocks_sha256(data, 65536) == jhash.get_blocks_sha256(data, 65536)
    path = tmp_path / "blob"
    path.write_bytes(data)
    assert thash.get_file_blocks_sha256(path, 65536) == jhash.get_file_blocks_sha256(path, 65536)
    assert list(thash.iter_file_blocks(io.BytesIO(data), 65536)) == list(jhash.iter_file_blocks(io.BytesIO(data), 65536))


def test_tokens_equal_jax_and_verify_across():
    claims, secret = {"sub": "input-plane", "exp": int(time.time()) + 60}, b"k" * 32
    token = tjwt.encode_jwt(claims, secret)
    assert token == jjwt.encode_jwt(claims, secret)
    assert jjwt.verify_jwt(token, secret) == tjwt.verify_jwt(token, secret) == claims
    assert tjwt.verify_jwt(token, b"other") is None
    assert tjwt.verify_jwt(tjwt.encode_jwt(claims, secret, ttl_s=-1), secret) is None


def _fail():
    raise KeyError("x")


def test_traceback_frames_cross_both_ways():
    try:
        _fail()
    except KeyError as exc:
        tb = exc.__traceback__
    assert ttb.capture_traceback_frames(tb) == jtb.capture_traceback_frames(tb)
    for ser, de in ((ttb.serialize_traceback, jtb.deserialize_traceback),
                    (jtb.serialize_traceback, ttb.deserialize_traceback)):
        rebuilt = de(ser(tb))
        names = []
        while rebuilt is not None:
            names.append((rebuilt.tb_frame.f_code.co_name, rebuilt.tb_lineno))
            rebuilt = rebuilt.tb_next
        assert names[-1] == ("_fail", _fail.__code__.co_firstlineno + 1)
    assert ttb.deserialize_traceback(b"") is None and ttb.deserialize_traceback(b"junk") is None


def test_output_manager_writes_what_jax_writes():
    streams = {}
    for name, mod in (("port", toutput), ("jax", joutput)):
        out = io.StringIO()
        mgr = mod.OutputManager(out)
        mgr.step("building")
        mgr.done("built")
        mgr.warning("slow")
        with mgr.status("serving"):
            pass
        streams[name] = out.getvalue()
        assert mod.get_output_manager() is None
        mod.step("silent when disabled")
    assert streams["port"] == streams["jax"] and streams["port"].count("\n") == 4
    with toutput.enable_output(plain=True) as mgr:
        assert toutput.get_output_manager() is mgr
    assert toutput.get_output_manager() is None


def test_log_backfill_reads_what_the_jax_client_reads(supervisor):
    tclient._Client.set_env_client(None)
    client = tclient.Client.from_env()
    try:
        app_id = tasync.synchronizer.run(_create_app(client))
        app = supervisor.state.apps[app_id]
        t0 = time.time()
        for i in range(700):  # denser than one refine threshold, so the histogram splits
            app.log_entries.append(japi.TaskLogs(data=f"line {i}", timestamp=t0 + i * 1e-3, task_id="ta-1",
                                                 file_descriptor=1))
        want = [e.data for e in _collect_jax(app_id, {})]
        got = tasync.synchronizer.run(_collect(tlogs.fetch_app_logs(client, app_id)))
        assert got == want == [f"line {i}" for i in range(700)]
        window = {"min_timestamp": t0 + 0.1, "max_timestamp": t0 + 0.3}
        got_w = tasync.synchronizer.run(_collect(tlogs.fetch_app_logs_bucketed(client, app_id, **window)))
        assert got_w == [e.data for e in _collect_jax(app_id, window, bucketed=True)] and 150 <= len(got_w) <= 250
        out = io.StringIO()
        tasync.synchronizer.run(tlogs.print_app_logs(client, app_id, out, **window))
        assert out.getvalue().splitlines() == got_w
    finally:
        client._close()
        tclient._Client.set_env_client(None)


async def _create_app(client):
    from modal_tpu_torch._utils.grpc_utils import retry_transient_errors
    from modal_tpu_torch.proto import api_pb2

    resp = await retry_transient_errors(client.stub.AppCreate, api_pb2.AppCreateRequest(description="logs"))
    return resp.app_id


async def _collect(agen):
    return [e.data async for e in agen]


def _collect_jax(app_id, window, bucketed=False):
    jclient = JClient.from_env()

    async def run():
        fetch = jlogs.fetch_app_logs_bucketed if bucketed else jlogs.fetch_app_logs
        return [e async for e in fetch(jclient, app_id, **window)]

    return jsync.run(run())
