"""Serving: dynamic request batching for `Phenaki.sample` (counterpart of
phenaki_tpu/serving.py).

A sample's throughput rises steeply with its batch (the decode loop issues
the same launches at b = 1 as at b = 8), so a server coalesces concurrent
requests into one batched sample.

`PhenakiServer` runs the standard dynamic-batching loop:

  * callers submit prompts (text or precomputed embeddings) and get a
    Future;
  * a dispatcher thread drains the queue, waits up to `max_delay_ms` for
    more requests, pads the batch to the nearest bucket with its last row,
    runs ONE `sample`, and hands the result to a resolver thread;
  * text is encoded in the dispatcher (`Phenaki.embed_texts`, on the
    model's device), so a batch mixing text and embeddings reduces to
    embeddings;
  * multi-scene requests (`submit_video`) group by their launch signature
    and chain scenes as `make_video` does, one batched sample a scene, the
    primes staying on the device between scenes.

Overload is explicit: the submit queue is bounded (`max_queue`) and sheds
load by failing the future with `ServerOverloaded`; the resolver queue is
bounded too (`resolve_depth` launches in delivery, then the dispatcher
blocks). A request's `deadline` (seconds) fails it with `DeadlineExceeded`
if it expires while queued. A batch whose sample raises fails its group's
futures and the server keeps serving.

Randomness: the server holds one CPU `torch.Generator` seeded with `seed`,
used by the dispatcher alone; each launch samples with a fresh CPU generator
seeded from a number drawn from it. A fixed `seed` makes the server
deterministic for a given (arrival order, bucket) schedule, and identical
prompts in one launch still decode different videos.

Delivery: on the card the dispatcher enqueues the copy of the finished
videos into pinned host memory on the stream that computed them and records
an event after it; the resolver waits on that event alone, so a launch's
futures resolve while the next launch computes. The resolver copies the
launch out of pinned memory in one call, and each future gets its row of
that pageable copy (as JAX's `device_get`), so a caller that keeps a video
keeps no pinned memory. The uint8 output is quantised on the device first
(`to_uint8`), a quarter of the float32 bytes.

`serve_http` wraps a server in a minimal JSON/HTTP front end (stdlib only):
POST /generate {"text": ...} -> {"video_gif_b64": ...}.

On a mesh (`mesh=`, JAX `serving.py:143,156,300,447,495`): JAX's server is
one process driving every device; here every rank of the mesh builds the
server alike. Rank 0 runs the dispatcher and the resolver and takes the
requests; every other rank runs a follower thread. Each launch (a sample,
or one scene of a video batch) is broadcast from rank 0 over a control
group of its own (no collective timeout: a server may idle for hours):
its text embeddings, prime frames and seed on the CPU; then every rank
joins the same `Phenaki.sample(mesh=)`, and the followers drop the result.
`close()` on rank 0 broadcasts a stop; on a follower it returns when that
stop has arrived. `serve_http` binds on rank 0 only; on a follower it
returns once the server is closed.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import queue
import tempfile
import threading
import time
from concurrent.futures import Future
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from phenaki_tpu_torch.parallel import collectives
from phenaki_tpu_torch.parallel.mesh import Mesh

_NO_TIMEOUT = timedelta(days=365)


class ServerOverloaded(RuntimeError):
    """Submit queue full: request shed at admission."""


class DeadlineExceeded(TimeoutError):
    """Request expired before a launch took it."""


def to_uint8(video: torch.Tensor) -> torch.Tensor:
    """clip(v * 255, 0, 255) truncated to uint8, computed in float32 (the
    TPU server's `_to_u8`)."""
    return (video.float() * 255.0).clamp(0.0, 255.0).to(torch.uint8)


class _Request:
    __slots__ = ("text", "text_embeds", "future", "deadline_ts", "scene_texts",
                 "scene_num_frames", "prime_lengths", "prime_video")

    def __init__(self, text, text_embeds, deadline_ts, scene_texts=None, scene_num_frames=None,
                 prime_lengths=None, prime_video=None):
        self.text = text
        self.text_embeds = text_embeds
        self.deadline_ts = deadline_ts  # monotonic seconds or None
        # a multi-scene (make_video) request: one prompt a scene and the
        # chaining structure; None for single-scene requests
        self.scene_texts = scene_texts
        self.scene_num_frames = scene_num_frames
        self.prime_lengths = prime_lengths
        # client-uploaded (f, H, W, c) float32 frames that scene 0 continues
        self.prime_video = prime_video
        self.future: Future = Future()

    def expired(self) -> bool:
        return self.deadline_ts is not None and time.monotonic() > self.deadline_ts

    def signature(self):
        """Launch-compatibility key: requests in one launch share the scene
        count, frames, prime lengths and uploaded-prime shape. Single-scene
        requests all share the signature None."""
        if self.scene_texts is None:
            return None
        prime_shape = None if self.prime_video is None else tuple(self.prime_video.shape)
        return (self.scene_num_frames, self.prime_lengths, prime_shape)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pad_rows(t: torch.Tensor, bucket: int) -> torch.Tensor:
    """Pad the batch axis to `bucket` with copies of the last row."""
    n = t.shape[0]
    if bucket == n:
        return t
    return torch.cat([t, t[-1:].expand(bucket - n, *t.shape[1:])])


class PhenakiServer:
    """Dynamic-batching sampler around a (trained) port `Phenaki`.

    Parameters mirror `Phenaki.sample`; `batch_buckets` are the batch sizes
    a launch takes (requests pad up to the nearest bucket; oversize bursts
    split across launches). `max_queue` bounds admitted-but-unbatched
    requests (0 = unbounded); `resolve_depth` bounds launches whose results
    are still being delivered (the dispatcher blocks when full). Results are
    numpy arrays (f, H, W, c) of `output_dtype`, "uint8" or "float32"."""

    def __init__(self, phenaki, *, num_frames: int = 17, cond_scale: float = 5.0,
                 starting_temperature: float = 0.9, batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 max_delay_ms: float = 20.0, seed: int = 0, mesh=None,
                 output_dtype: str = "uint8", max_queue: int = 256, resolve_depth: int = 4):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not {type(mesh).__name__}")
        if output_dtype not in ("uint8", "float32"):
            raise ValueError(f"output_dtype must be 'uint8' or 'float32', not {output_dtype!r}")
        self.model = phenaki
        self.device = phenaki.maskgit.to_logits.weight.device
        self.num_frames = num_frames
        self.cond_scale = cond_scale
        self.starting_temperature = starting_temperature
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.max_delay_ms = max_delay_ms
        self.output_dtype = output_dtype
        self._generator = torch.Generator().manual_seed(seed)  # the dispatcher's alone
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(maxsize=max_queue)
        self._launches: List[Tuple[int, int]] = []  # (requests, bucket)
        self._shed = 0
        self._expired = 0
        self._closed = False
        self._close_lock = threading.Lock()
        self._resolve_q: "queue.Queue" = queue.Queue(maxsize=resolve_depth)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._control = None
        self._launch_lock = threading.Lock()  # rank 0: one launch at a time
        if self.mesh is not None:
            self._control = dist.new_group(list(range(self.mesh.size)), backend="gloo",
                                           timeout=_NO_TIMEOUT)
        if self.mesh is not None and self.mesh.rank != 0:
            self._thread = threading.Thread(target=self._follow_loop, daemon=True)
            self._thread.start()
            self._resolver = None
            return
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()
        self._resolver = threading.Thread(target=self._resolve_loop, daemon=True)
        self._resolver.start()

    @property
    def is_follower(self) -> bool:
        return self.mesh is not None and self.mesh.rank != 0

    def _sample(self, **kwargs) -> torch.Tensor:
        """One launch: `Phenaki.sample`; on a mesh, broadcast to the
        followers first (CPU copies) and run on every rank."""
        if self.mesh is None:
            return self.model.sample(**kwargs)
        with self._launch_lock:
            kwargs["seed"] = kwargs.pop("generator").initial_seed()  # a fresh launch generator
            collectives.broadcast_object(("sample", _to_host(kwargs)), self._control)
            return self._mesh_sample(kwargs)

    def _mesh_sample(self, kwargs: dict) -> torch.Tensor:
        kwargs = dict(kwargs)
        generator = torch.Generator().manual_seed(kwargs.pop("seed"))
        for k in ("text_embeds", "prime_frames"):
            if kwargs.get(k) is not None:
                kwargs[k] = kwargs[k].to(self.device)
        return self.model.sample(generator=generator, mesh=self.mesh, **kwargs)

    def _follow_loop(self):
        """A follower: join every launch rank 0 broadcasts, until the stop."""
        with self._device_context(), torch.inference_mode():
            while True:
                kind, kwargs = collectives.broadcast_object(None, self._control)
                if kind == "stop":
                    return
                try:
                    self._mesh_sample(kwargs)
                except Exception:  # rank 0 fails the launch's futures; keep following
                    pass

    # client API

    def submit(self, text: Optional[str] = None, text_embeds=None,
               deadline: Optional[float] = None) -> Future:
        """Enqueue one prompt; resolves to a (f, H, W, c) video array.

        `text_embeds` (L, d) is a tensor or an array. `deadline`
        (seconds from now): if the request is still queued when it expires,
        its future fails with DeadlineExceeded. If the admission queue is
        full the future fails at once with ServerOverloaded."""
        if (text is None) == (text_embeds is None):
            raise ValueError("pass exactly one of text / text_embeds")
        deadline_ts = None if deadline is None else time.monotonic() + deadline
        return self._admit(_Request(text, text_embeds, deadline_ts))

    def submit_video(self, texts: Sequence[str], num_frames=None, prime_lengths=5,
                     prime_video=None, deadline: Optional[float] = None) -> Future:
        """Enqueue a multi-scene `make_video` request: one prompt a scene,
        each scene primed on the last `prime_lengths` frames of the one
        before. Resolves to the chained (sum(num_frames), H, W, c) video.

        `num_frames`: int or one a scene (default: the server's
        `num_frames`). `prime_lengths`: int or one a scene transition.
        `prime_video`: optional (f, H, W, c) frames, float in [0, 1] or
        uint8, that scene 0 continues. Requests of one signature
        (`_Request.signature`) share each scene's launch."""
        texts = list(texts)
        if not texts:
            raise ValueError("need at least one scene prompt")
        n_scenes = len(texts)
        if num_frames is None:
            num_frames = self.num_frames
        if isinstance(num_frames, int):
            num_frames = (num_frames,) * n_scenes
        num_frames = tuple(int(f) for f in num_frames)
        if len(num_frames) != n_scenes:
            raise ValueError("num_frames must have one entry per scene")
        if isinstance(prime_lengths, int):
            prime_lengths = (prime_lengths,) * (n_scenes - 1)
        prime_lengths = tuple(int(p) for p in prime_lengths)
        if len(prime_lengths) != n_scenes - 1:
            raise ValueError("prime_lengths must have one entry per scene transition")
        if prime_video is not None:
            prime_video = np.asarray(prime_video)
            if prime_video.dtype == np.uint8:
                prime_video = prime_video.astype(np.float32) / 255.0
            prime_video = prime_video.astype(np.float32)
            if prime_video.ndim != 4:
                raise ValueError("prime_video must be (f, H, W, c)")
        deadline_ts = None if deadline is None else time.monotonic() + deadline
        req = _Request(None, None, deadline_ts, scene_texts=texts, scene_num_frames=num_frames,
                       prime_lengths=prime_lengths, prime_video=prime_video)
        return self._admit(req)

    def _admit(self, req: _Request) -> Future:
        with self._close_lock:
            if self._closed:
                req.future.set_exception(RuntimeError("server is closed"))
                return req.future
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self._shed += 1
                req.future.set_exception(
                    ServerOverloaded(f"submit queue full ({self._queue.maxsize} pending)"))
        return req.future

    def generate(self, texts: Sequence[str]) -> np.ndarray:
        """Synchronous convenience: submit all, wait, stack."""
        futures = [self.submit(text=t) for t in texts]
        return np.stack([f.result() for f in futures])

    def prewarm(self):
        """Build and load the kernels on the caller's thread, load the text
        encoder, and run one dummy launch a bucket, so that no request pays
        the build, the encoder's load, the allocator's growth or a kernel's
        first launch. Blocking; call before serving. `launch_log` is left as
        it was."""
        with self._device_context(), torch.inference_mode():
            if self.device.type == "cuda":
                from phenaki_tpu_torch import _build

                _build.load_library()
            self.model.embed_texts([""])
            if self.is_follower:
                return  # the follower thread joins rank 0's launches
            dummy = torch.zeros(1, self.model.max_text_len, self.model.text_embed_dim,
                                device=self.device)
            for b in self.batch_buckets:
                videos = self._sample(
                    num_frames=self.num_frames, text_embeds=dummy.expand(b, -1, -1),
                    cond_scale=self.cond_scale, starting_temperature=self.starting_temperature,
                    generator=torch.Generator().manual_seed(0))
                self._to_output(videos)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def close(self, timeout: Optional[float] = 60.0):
        """Stop serving. On a mesh rank 0 broadcasts a stop after its last
        launch; a follower returns when that stop has arrived (at most
        `timeout` seconds later; None waits without end)."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if self.is_follower:
            self._thread.join(timeout=timeout)
            return
        self._queue.put(None)
        self._thread.join(timeout=60)
        if self.mesh is not None:
            with self._launch_lock:
                collectives.broadcast_object(("stop", None), self._control)
        self._resolve_q.put(None)
        self._resolver.join(timeout=60)
        # fail anything that raced the sentinel
        self._fail_pending(RuntimeError("server is closed"))

    def _fail_pending(self, exc: Exception):
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(exc)
        while True:
            try:
                item = self._resolve_q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            for req in item[2]:
                if not req.future.done():
                    req.future.set_exception(exc)

    @property
    def launch_log(self) -> List[Tuple[int, int]]:
        """(num_real_requests, bucket_size) per launch (telemetry)."""
        return list(self._launches)

    @property
    def stats(self) -> dict:
        return {"launches": len(self._launches), "shed": self._shed, "expired": self._expired,
                "pending": self._queue.qsize()}

    # dispatcher

    def _device_context(self):
        """The model's card as the thread's current device: the kernels
        launch on the calling thread's current device and stream."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _collect(self) -> Optional[List[_Request]]:
        """Block for the first live request, then coalesce up to the largest
        bucket for at most max_delay_ms. Expired requests are failed and
        dropped."""
        while True:
            first = self._queue.get()
            if first is None:
                return None
            if first.expired():
                self._drop_expired(first)
                continue
            break
        batch = [first]
        max_b = self.batch_buckets[-1]
        window = self.max_delay_ms / 1000.0
        t0 = time.monotonic()
        while len(batch) < max_b:
            remaining = window - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._queue.put(None)  # re-signal shutdown for the next loop
                break
            if req.expired():
                self._drop_expired(req)
                continue
            batch.append(req)
        return batch

    def _drop_expired(self, req: _Request):
        self._expired += 1
        if not req.future.done():
            req.future.set_exception(DeadlineExceeded("request expired before batching"))

    def _dispatch_loop(self):
        # inference mode and the current device are per thread
        with self._device_context(), torch.inference_mode():
            while True:
                batch = self._collect()
                if batch is None:
                    return
                groups: dict = {}
                for req in batch:
                    groups.setdefault(req.signature(), []).append(req)
                for sig, group in groups.items():
                    try:
                        if sig is None:
                            self._run_batch(group)
                        else:
                            self._run_video_batch(group)
                    except Exception as e:  # fail this group's futures, keep serving
                        for req in group:
                            if not req.future.done():
                                req.future.set_exception(e)

    def _launch_generator(self) -> torch.Generator:
        seed = int(torch.randint(0, 2**62, (), generator=self._generator))
        return torch.Generator().manual_seed(seed)

    def _embeds_row(self, text_embeds) -> torch.Tensor:
        """One request's (L, d) embeddings -> (max_text_len, d) f32 on the
        model's device."""
        if not torch.is_tensor(text_embeds):
            text_embeds = torch.from_numpy(np.asarray(text_embeds, dtype=np.float32))
        return self.model.pad_text_embeds(text_embeds.to(self.device, torch.float32)[None])[0]

    def _run_batch(self, batch: List[_Request]):
        n = len(batch)
        bucket = _bucket(n, self.batch_buckets)
        rows: List[Optional[torch.Tensor]] = [
            None if r.text_embeds is None else self._embeds_row(r.text_embeds) for r in batch]
        text_idx = [i for i, r in enumerate(batch) if r.text is not None]
        if text_idx:
            encoded = self.model.embed_texts([batch[i].text for i in text_idx])
            for slot, i in enumerate(text_idx):
                rows[i] = encoded[slot]
        embeds = _pad_rows(torch.stack(rows), bucket)
        videos = self._sample(
            num_frames=self.num_frames, text_embeds=embeds, cond_scale=self.cond_scale,
            starting_temperature=self.starting_temperature, generator=self._launch_generator())
        self._launches.append((n, bucket))
        self._handoff(self._to_output(videos), batch)

    def _run_video_batch(self, batch: List[_Request]):
        """One signature group of multi-scene requests, chained scene by
        scene as `make_video` does; each scene is one batched launch and the
        primes stay on the device."""
        n = len(batch)
        bucket = _bucket(n, self.batch_buckets)
        prime_lengths = (*batch[0].prime_lengths, 0)  # the last scene primes nothing
        video_prime = None
        if batch[0].prime_video is not None:
            uploaded = torch.from_numpy(np.stack([r.prime_video for r in batch]))
            video_prime = _pad_rows(uploaded.to(self.device), bucket)
        scenes = []
        for s, (frames, next_prime) in enumerate(zip(batch[0].scene_num_frames, prime_lengths)):
            embeds = _pad_rows(self.model.embed_texts([r.scene_texts[s] for r in batch]), bucket)
            video = self._sample(
                num_frames=frames, text_embeds=embeds, prime_frames=video_prime,
                cond_scale=self.cond_scale, starting_temperature=self.starting_temperature,
                generator=self._launch_generator())
            scenes.append(video)
            video_prime = video[:, -next_prime:] if next_prime > 0 else None
            self._launches.append((n, bucket))
        self._handoff(self._to_output(torch.cat(scenes, dim=1)), batch)

    def _to_output(self, videos: torch.Tensor) -> torch.Tensor:
        return to_uint8(videos) if self.output_dtype == "uint8" else videos.float()

    def _handoff(self, videos: torch.Tensor, batch: List[_Request]):
        """Pass a launch's videos to the resolver. On the card: a copy into
        pinned host memory on the stream that computed them, and an event
        after it, which is all the resolver waits on. The device tensor is
        released here, on its own stream, once the copy is enqueued."""
        done = None
        if videos.is_cuda:
            host = torch.empty(videos.shape, dtype=videos.dtype, pin_memory=True)
            host.copy_(videos, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record()
        else:
            host = videos
        self._resolve_q.put((host, done, batch))

    def _resolve_loop(self):
        while True:
            item = self._resolve_q.get()
            if item is None:
                return
            host, done, batch = item
            try:
                if done is not None:
                    done.synchronize()
                # one pageable copy: a view would keep the pinned block alive, and
                # a copy a row would wait for the GIL once a row
                videos = host.numpy().copy()
                for i, req in enumerate(batch):
                    req.future.set_result(videos[i])
            except Exception as e:
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)


def _to_host(kwargs: dict) -> dict:
    """A launch's arguments with its tensors on the CPU, for the broadcast."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}


# minimal HTTP front end (stdlib only)


def _video_to_gif_b64(video: np.ndarray) -> str:
    from phenaki_tpu_torch.data.codecs import video_tensor_to_gif

    if video.dtype == np.uint8:
        video = video.astype(np.float32) / 255.0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "v.gif")
        video_tensor_to_gif(np.clip(video, 0.0, 1.0), path)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()


def _gif_b64_to_video(b64: str) -> np.ndarray:
    """Inverse of `_video_to_gif_b64`: base64 GIF -> (f, H, W, c) float32."""
    from phenaki_tpu_torch.data.codecs import gif_to_tensor

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "v.gif")
        with open(path, "wb") as f:
            f.write(base64.b64decode(b64))
        return np.asarray(gif_to_tensor(path), np.float32)


def serve_http(server: PhenakiServer, port: int = 8089, max_requests=None,
               request_timeout: float = 120.0):
    """Blocking JSON/HTTP endpoint on 127.0.0.1: POST /generate {"text": ...}
    and POST /generate_video {"texts": [...], "num_frames": int | [...],
    "prime_lengths": int | [...], "prime_video_b64": optional base64 GIF
    whose last "prime_frames" frames scene 0 continues} -> {"video_gif_b64":
    ...}; GET /healthz -> ok, GET /stats -> the server's stats. Each request
    carries a `request_timeout`-second deadline end to end; overload and
    expiry return 503. `max_requests` bounds the serve loop. On a mesh only
    rank 0 binds; a follower waits for the server's close and returns None."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if server.is_follower:
        server.close(timeout=None)
        return None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                body = b"ok"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stats":
                self._json(200, server.stats)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            if self.path not in ("/generate", "/generate_video"):
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            try:
                if self.path == "/generate":
                    future = server.submit(text=payload["text"], deadline=request_timeout)
                else:
                    prime_video = None
                    if payload.get("prime_video_b64"):
                        prime_video = _gif_b64_to_video(payload["prime_video_b64"])
                        n_prime = payload.get("prime_frames")
                        if n_prime:  # the client may send more frames than are used
                            prime_video = prime_video[-int(n_prime):]
                    future = server.submit_video(
                        payload["texts"], num_frames=payload.get("num_frames"),
                        prime_lengths=payload.get("prime_lengths", 5), prime_video=prime_video,
                        deadline=request_timeout)
                video = future.result(timeout=request_timeout)
                self._json(200, {"video_gif_b64": _video_to_gif_b64(video)})
            except (ServerOverloaded, DeadlineExceeded, TimeoutError) as e:
                self._json(503, {"error": str(e)})
            except Exception as e:
                self._json(500, {"error": str(e)})

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    if max_requests is None:
        httpd.serve_forever()
    else:
        for _ in range(max_requests):
            httpd.handle_request()
    httpd.server_close()
    return httpd
