"""The port's dynamic-batching server (phenaki_tpu_torch/serving.py) against
the JAX package's, fp32 on the CPU, on bridged weights of the tiny pair of
tests/test_serving.py.

Parity: greedy decoding (starting_temperature 0) needs no shared random
stream, so the same requests through JAX's `PhenakiServer` and the port's
give the same videos: three embeddings requests coalesced into one bucket-4
launch and one 2-scene `submit_video` from texts (the hash encoder on both
sides), within atol 1e-4 in float32; in uint8 equal except where the two
float videos straddle an integer after x 255, and at most 1 apart there.
JAX's servers run once, in one module-scoped fixture (their compile is what
makes tests/test_serving.py slow). The port's `to_uint8` equals JAX's
`_to_u8` bit for bit.

Port-only counterparts of every other test of tests/test_serving.py:
coalescing and the launch log, decorrelated identical prompts, error
isolation, uint8 against the quantised float32 of a server with the same
seed, shedding, deadlines, mixed text and embeddings, `close`, multi-scene
videos, mixed single and video requests, uploaded primes, the HTTP front
end (with a TokenCritic too), `prewarm`; a `mesh=` that is no Mesh raises. Every wait is
bounded: results take a timeout, servers close in `finally`, and the HTTP
tests bind a free port and poll /healthz with a deadline.
"""

import base64
import contextlib
import json
import os
import socket
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from phenaki_tpu.models.cvivit import CViViT as JCViViT  # noqa: E402
from phenaki_tpu.models.maskgit import MaskGit as JMaskGit  # noqa: E402
from phenaki_tpu.models.phenaki import Phenaki as JPhenaki  # noqa: E402
from phenaki_tpu.serving import PhenakiServer as JServer  # noqa: E402
from phenaki_tpu_torch.bridge import load_cvivit_variables, load_phenaki_params
from phenaki_tpu_torch.data.codecs import video_tensor_to_gif
from phenaki_tpu_torch.models.cvivit import CViViT
from phenaki_tpu_torch.models.maskgit import MaskGit, TokenCritic
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.ops.torch_init import init_parameters
from phenaki_tpu_torch.serving import (DeadlineExceeded, PhenakiServer, ServerOverloaded,
                                       _gif_b64_to_video, serve_http, to_uint8)

torch.set_num_threads(1)

TEXT_DIM = 16
CVIVIT = dict(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
              spatial_depth=1, temporal_depth=1, dim_head=16, heads=2)
MASKGIT = dict(dim=32, num_tokens=64, max_seq_len=16, depth=1, heads=2, dim_head=16,
               dim_context=TEXT_DIM)
PHENAKI = dict(steps=2, text_embed_dim=TEXT_DIM, max_text_len=4)
WAIT = 120  # seconds any result may take
COALESCE_MS = 1000.0  # a window the few submits of a test always fall in
# the parity requests: three embeddings requests and one 2-scene video
PARITY_SERVER = dict(num_frames=3, cond_scale=2.0, starting_temperature=0.0,
                     batch_buckets=(1, 2, 4), max_delay_ms=COALESCE_MS, seed=0)
PARITY_EMBEDS = np.random.RandomState(0).randn(3, 3, TEXT_DIM).astype(np.float32)
PARITY_VIDEO = dict(texts=["a red square", "it moves right"], num_frames=(3, 4), prime_lengths=1)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny Phenaki of tests/test_serving.py and the port's on its
    bridged weights."""
    jcv = JCViViT(**CVIVIT)
    cv_vars = jcv.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16, 3)))
    jph = JPhenaki(maskgit=JMaskGit(**MASKGIT), cvivit=jcv, cvivit_vars=cv_vars, **PHENAKI)
    jph.init(jax.random.PRNGKey(1))
    cv = load_cvivit_variables(CViViT(**CVIVIT), _numpy_tree(cv_vars))
    tph = Phenaki(maskgit=MaskGit(**MASKGIT), cvivit=cv, **PHENAKI)
    return jph, load_phenaki_params(tph, _numpy_tree(jph.params))


@pytest.fixture(scope="module")
def tiny(pair):
    return pair[1]


def _run_parity_requests(server_cls, model, output_dtype):
    """The parity requests through one server: (the three single videos,
    the 2-scene video, launch log, the server)."""
    server = server_cls(model, output_dtype=output_dtype, **PARITY_SERVER)
    try:
        futures = [server.submit(text_embeds=e) for e in PARITY_EMBEDS]
        singles = [np.asarray(f.result(timeout=WAIT)) for f in futures]
        video = np.asarray(server.submit_video(**PARITY_VIDEO).result(timeout=WAIT))
        return singles, video, server.launch_log, server
    finally:
        server.close()


@pytest.fixture(scope="module")
def jax_served(pair):
    """JAX's servers, run once: float32 and uint8."""
    return {dtype: _run_parity_requests(JServer, pair[0], dtype) for dtype in ("float32", "uint8")}


@pytest.fixture(scope="module")
def port_served(tiny):
    return {dtype: _run_parity_requests(PhenakiServer, tiny, dtype) for dtype in ("float32", "uint8")}


def _float_then_u8(served, i):
    """(float32 video, uint8 video) of parity output i (3 = the video)."""
    pick = (lambda r: r[0][i]) if i < 3 else (lambda r: r[1])
    return pick(served["float32"]), pick(served["uint8"])


@pytest.mark.parametrize("which", [0, 1, 2, 3], ids=["single0", "single1", "single2", "video"])
def test_served_videos_match_jax(jax_served, port_served, which):
    j_f32, j_u8 = _float_then_u8(jax_served, which)
    p_f32, p_u8 = _float_then_u8(port_served, which)
    assert p_f32.dtype == np.float32 and p_u8.dtype == np.uint8
    assert p_f32.shape == j_f32.shape == ((3, 16, 16, 3) if which < 3 else (7, 16, 16, 3))
    np.testing.assert_allclose(p_f32, j_f32, atol=1e-4, rtol=0)
    # uint8: equal unless the float videos straddle an integer after x 255
    straddle = (np.floor(np.clip(p_f32 * 255.0, 0, 255)) != np.floor(np.clip(j_f32 * 255.0, 0, 255)))
    diff = np.abs(p_u8.astype(np.int16) - j_u8.astype(np.int16))
    np.testing.assert_array_equal(p_u8[~straddle], j_u8[~straddle])
    assert diff.max() <= 1


def test_launch_logs_match_jax(jax_served, port_served):
    for dtype in ("float32", "uint8"):
        assert port_served[dtype][2] == jax_served[dtype][2] == [(3, 4), (1, 1), (1, 1)]


def test_to_uint8_matches_jax_bit_for_bit(jax_served):
    rs = np.random.RandomState(3)
    v = np.concatenate([rs.uniform(-0.5, 1.5, 20000), np.arange(256) / 255.0,
                        np.nextafter(np.arange(256) / 255.0, 2.0), [0.0, 1.0, -0.0]]).astype(np.float32)
    expected = np.asarray(jax_served["uint8"][3]._to_u8(jnp.asarray(v)))
    np.testing.assert_array_equal(to_uint8(torch.from_numpy(v)).numpy(), expected)


# port-only counterparts of tests/test_serving.py


def _embeds(seed, b=None):
    shape = (3, TEXT_DIM) if b is None else (b, 3, TEXT_DIM)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@contextlib.contextmanager
def _server(model, **kw):
    server = PhenakiServer(model, **{"num_frames": 3, "cond_scale": 2.0, **kw})
    try:
        yield server
    finally:
        server.close()


def test_server_batches_concurrent_requests(tiny):
    with _server(tiny, batch_buckets=(1, 2, 4), max_delay_ms=COALESCE_MS, seed=0) as server:
        futures = [server.submit(text_embeds=e) for e in _embeds(0, b=3)]
        videos = [f.result(timeout=WAIT) for f in futures]
        for v in videos:
            assert v.shape == (3, 16, 16, 3) and v.dtype == np.uint8
        # three concurrent submits coalesce into one launch padded to bucket 4
        assert server.launch_log == [(3, 4)]
        assert server.stats == {"launches": 1, "shed": 0, "expired": 0, "pending": 0}


@pytest.mark.parametrize("output_dtype", ["uint8", "float32"])
def test_server_results_are_rows_of_a_numpy_copy(tiny, output_dtype):
    # each future holds a row of a numpy-owned copy of its launch, not a view
    # of the tensor the launch was copied into (pinned memory on the card)
    with _server(tiny, batch_buckets=(2,), max_delay_ms=COALESCE_MS, seed=0,
                 output_dtype=output_dtype) as server:
        futures = [server.submit(text_embeds=e) for e in _embeds(8, b=2)]
        videos = [f.result(timeout=WAIT) for f in futures]
    assert server.launch_log == [(2, 2)]
    for i, v in enumerate(videos):
        assert v.dtype == np.dtype(output_dtype) and v.shape == (3, 16, 16, 3)
        assert isinstance(v.base, np.ndarray) and v.base.base is None and v.base.flags.owndata
        np.testing.assert_array_equal(v, v.base[i])


def test_server_decorrelates_identical_prompts(tiny):
    with _server(tiny, batch_buckets=(2,), max_delay_ms=COALESCE_MS, seed=1,
                 output_dtype="float32") as server:
        emb = _embeds(1)
        f1, f2 = server.submit(text_embeds=emb), server.submit(text_embeds=emb)
        v1, v2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
        assert server.launch_log == [(2, 2)]
        assert not np.allclose(v1, v2), "identical prompts in one launch must sample different videos"


def test_server_is_deterministic_for_a_seed(tiny):
    outs = []
    for _ in range(2):
        with _server(tiny, batch_buckets=(1,), max_delay_ms=1.0, seed=4) as server:
            outs.append([server.submit(text_embeds=_embeds(s)).result(timeout=WAIT) for s in (2, 3)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_server_isolates_request_errors(tiny):
    with _server(tiny, batch_buckets=(1, 2), max_delay_ms=5.0) as server:
        bad = server.submit(text_embeds=np.zeros((5, 5, 5, 5)))  # bad shape
        with pytest.raises(ValueError):
            bad.result(timeout=WAIT)
        # the server keeps serving after a failed batch
        assert server.submit(text_embeds=_embeds(2)).result(timeout=WAIT).shape == (3, 16, 16, 3)


def test_uint8_output_matches_quantized_float(tiny):
    emb = _embeds(5)
    with _server(tiny, batch_buckets=(1,), max_delay_ms=1.0, seed=7) as s_u8, \
            _server(tiny, batch_buckets=(1,), max_delay_ms=1.0, seed=7, output_dtype="float32") as s_f32:
        v_u8 = s_u8.submit(text_embeds=emb).result(timeout=WAIT)
        v_f32 = s_f32.submit(text_embeds=emb).result(timeout=WAIT)
    assert v_u8.dtype == np.uint8 and v_f32.dtype == np.float32
    np.testing.assert_array_equal(v_u8, np.clip(v_f32 * 255.0, 0, 255).astype(np.uint8))


def test_server_mesh_must_be_a_mesh(tiny):
    with pytest.raises(TypeError, match="Mesh"):
        PhenakiServer(tiny, mesh=object())


def test_server_sheds_load_when_queue_full(tiny):
    with _server(tiny, batch_buckets=(1,), max_delay_ms=1.0, max_queue=2) as server:
        # flood far beyond the 2-deep admission queue: some are shed
        futures = [server.submit(text_embeds=_embeds(3)) for _ in range(30)]
        outcomes = []
        for f in futures:
            try:
                f.result(timeout=WAIT)
                outcomes.append("ok")
            except ServerOverloaded:
                outcomes.append("shed")
        assert "shed" in outcomes and "ok" in outcomes
        assert server.stats["shed"] == outcomes.count("shed")


def test_concurrent_submitters_account_for_every_request(tiny):
    """16 threads submit at once under a short switch interval: every
    future resolves or is shed, the shed count is exact, and the launches
    carry exactly the served requests."""
    import sys

    futures, lock = [], threading.Lock()

    def submitter(seed):
        mine = [server.submit(text_embeds=_embeds(seed)) for _ in range(4)]
        with lock:
            futures.extend(mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _server(tiny, batch_buckets=(1, 2, 4), max_delay_ms=5.0, max_queue=8) as server:
            threads = [threading.Thread(target=submitter, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
            outcomes = []
            for f in futures:
                try:
                    f.result(timeout=WAIT)
                    outcomes.append("ok")
                except ServerOverloaded:
                    outcomes.append("shed")
            assert len(outcomes) == 64
            assert server.stats["shed"] == outcomes.count("shed")
            assert sum(n for n, _ in server.launch_log) == outcomes.count("ok") > 0
    finally:
        sys.setswitchinterval(interval)


def test_server_deadline_expiry(tiny):
    with _server(tiny, batch_buckets=(1,), max_delay_ms=1.0) as server:
        emb = _embeds(4)
        busy = server.submit(text_embeds=emb)
        doomed = server.submit(text_embeds=emb, deadline=0.0)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=WAIT)
        busy.result(timeout=WAIT)
        assert server.stats["expired"] >= 1


def test_server_mixed_text_and_embeds_batch(tiny):
    with _server(tiny, batch_buckets=(2,), max_delay_ms=COALESCE_MS) as server:
        f_text = server.submit(text="a red square moving right")
        f_emb = server.submit(text_embeds=_embeds(5))
        assert f_text.result(timeout=WAIT).shape == (3, 16, 16, 3)
        assert f_emb.result(timeout=WAIT).shape == (3, 16, 16, 3)
        assert server.launch_log == [(2, 2)]


def test_server_close_fails_stragglers(tiny):
    server = PhenakiServer(tiny, num_frames=3, batch_buckets=(1,), max_delay_ms=1.0)
    try:
        first = server.submit(text_embeds=_embeds(6))
    finally:
        server.close()
    late = server.submit(text_embeds=_embeds(6))
    with pytest.raises(RuntimeError, match="closed"):
        late.result(timeout=10)
    # the in-flight request either completed or was failed: never pending
    assert first.done()


def test_server_multi_scene_video(tiny):
    with _server(tiny, batch_buckets=(1, 2), max_delay_ms=COALESCE_MS, seed=3) as server:
        f1 = server.submit_video(["a red square", "it moves right"], num_frames=(3, 4), prime_lengths=1)
        f2 = server.submit_video(["a blue circle", "it moves left"], num_frames=(3, 4), prime_lengths=1)
        v1, v2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
        # a 3-frame scene and a 4-frame primed scene chained: 7 frames
        assert v1.shape == v2.shape == (7, 16, 16, 3)
        assert not np.array_equal(v1, v2)
        # one signature: each scene's launch carries both requests
        assert server.launch_log == [(2, 2), (2, 2)]


def test_server_mixed_single_and_video_requests(tiny):
    with _server(tiny, batch_buckets=(1, 2), max_delay_ms=COALESCE_MS) as server:
        f_single = server.submit(text_embeds=_embeds(8))
        f_video = server.submit_video(["one scene", "two scene"], num_frames=(3, 4), prime_lengths=1)
        assert f_single.result(timeout=WAIT).shape == (3, 16, 16, 3)
        assert f_video.result(timeout=WAIT).shape == (7, 16, 16, 3)
        # two signature groups of one dispatch: one launch, then two scenes
        assert server.launch_log == [(1, 1), (1, 1), (1, 1)]


def test_submit_video_uploaded_prime_coalesces(tiny):
    rs = np.random.RandomState(7)
    prime_a = rs.rand(1, 16, 16, 3).astype(np.float32)
    prime_b = (rs.rand(1, 16, 16, 3) * 255).astype(np.uint8)  # uint8 uploads are scaled to [0, 1]
    with _server(tiny, batch_buckets=(1, 2), max_delay_ms=COALESCE_MS, seed=9) as server:
        f1 = server.submit_video(["go left"], num_frames=(4,), prime_lengths=(), prime_video=prime_a)
        f2 = server.submit_video(["go right"], num_frames=(4,), prime_lengths=(), prime_video=prime_b)
        v1, v2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
        assert v1.shape == v2.shape == (4, 16, 16, 3)
        assert not np.array_equal(v1, v2)
        assert server.launch_log == [(2, 2)]


def test_server_prewarm_leaves_launch_log_empty(tiny):
    with _server(tiny, batch_buckets=(1, 2), max_delay_ms=1.0) as server:
        server.prewarm()
        assert server.launch_log == []
        assert server.submit(text_embeds=_embeds(7)).result(timeout=WAIT).shape == (3, 16, 16, 3)
        assert server.launch_log == [(1, 1)]


# the HTTP front end


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=WAIT) as r:
        return r.status, r.read()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.status, json.loads(r.read())


@contextlib.contextmanager
def _http(server, n_requests, **serve_kw):
    """`serve_http` on a free port in a thread, for `n_requests` requests,
    the first of them the /healthz poll that finds it up."""
    port = _free_port()
    thread = threading.Thread(target=serve_http, args=(server, port),
                              kwargs={"max_requests": n_requests, **serve_kw}, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 30
        while True:
            try:
                assert _get(port, "/healthz") == (200, b"ok")
                break
            except urllib.error.URLError:  # not listening yet
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)
        yield port
    finally:
        thread.join(timeout=30)
        server.close()
    assert not thread.is_alive()


def test_http_front_end(tiny):
    server = PhenakiServer(tiny, num_frames=3, cond_scale=2.0, batch_buckets=(1,), max_delay_ms=1.0)
    with _http(server, 3) as port:
        status, payload = _post(port, "/generate", {"text": "a bouncing ball"})
        assert status == 200
        assert _gif_b64_to_video(payload["video_gif_b64"]).shape == (3, 16, 16, 3)
        status, body = _get(port, "/stats")
        assert status == 200 and json.loads(body) == {"launches": 1, "shed": 0, "expired": 0,
                                                       "pending": 0}


def test_http_generate_video_endpoint(tiny):
    server = PhenakiServer(tiny, num_frames=3, cond_scale=2.0, batch_buckets=(1,), max_delay_ms=1.0)
    with _http(server, 2) as port:
        status, payload = _post(port, "/generate_video", {
            "texts": ["a ball appears", "the ball bounces"], "num_frames": [3, 4], "prime_lengths": 1})
        assert status == 200
        assert _gif_b64_to_video(payload["video_gif_b64"]).shape == (7, 16, 16, 3)


def test_http_generate_video_with_uploaded_prime(tiny):
    prime = np.random.RandomState(5).rand(3, 16, 16, 3).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p.gif")
        video_tensor_to_gif(prime, path)
        with open(path, "rb") as f:
            prime_b64 = base64.b64encode(f.read()).decode()
    server = PhenakiServer(tiny, num_frames=3, cond_scale=2.0, batch_buckets=(1,), max_delay_ms=1.0)
    with _http(server, 2) as port:
        status, payload = _post(port, "/generate_video", {
            "texts": ["continue this video", "then pan away"],
            # scene 0 is primed (on the upload): its frames are a multiple
            # of the temporal patch size
            "num_frames": [4, 4], "prime_lengths": 1, "prime_video_b64": prime_b64,
            "prime_frames": 1})
        assert status == 200
        # 4 + 4 chained frames, the client's prime not repeated
        assert _gif_b64_to_video(payload["video_gif_b64"]).shape == (8, 16, 16, 3)


def test_http_expiry_returns_503(tiny):
    server = PhenakiServer(tiny, num_frames=3, batch_buckets=(1,), max_delay_ms=1.0)
    with _http(server, 2, request_timeout=0.0) as port:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/generate", {"text": "too late"})
        assert err.value.code == 503


@pytest.fixture(scope="module")
def tiny_critic(tiny):
    """The tiny Phenaki with a TokenCritic of seeded torch weights."""
    critic = init_parameters(TokenCritic(**MASKGIT, has_cross_attn=True), torch.Generator().manual_seed(5))
    return Phenaki(maskgit=tiny.maskgit, cvivit=tiny.cvivit, critic=critic, **PHENAKI)


def test_http_with_token_critic(tiny_critic):
    server = PhenakiServer(tiny_critic, num_frames=3, cond_scale=2.0, batch_buckets=(1,),
                           max_delay_ms=1.0)
    with _http(server, 3) as port:
        status, payload = _post(port, "/generate", {"text": "a critic-scored square"})
        assert status == 200
        assert _gif_b64_to_video(payload["video_gif_b64"]).shape == (3, 16, 16, 3)
        status, payload = _post(port, "/generate_video", {
            "texts": ["scene one", "scene two"], "num_frames": [3, 4], "prime_lengths": 1})
        assert status == 200
        assert _gif_b64_to_video(payload["video_gif_b64"]).shape == (7, 16, 16, 3)
