"""The port's TinyYOLO REST server in-process on the CPU: the reference's
protocol, its answers against ``engine.predict``, and both packages' clients
against both packages' servers.

Across packages the two TinyYOLOs run the product bf16, which XLA and torch
round at other points: the same boxes per frame, each corner within
CROSS_PX pixels and each confidence within CROSS_CONF. Within the port the
answers are equal. The box outlines are bit-equal to ``cv2.rectangle``
(cv2 is imported here only)."""
import hashlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mav_detection_tpu.core.config import RunConfig as JRunConfig
from mav_detection_tpu.eval.validator import Validator as JValidator

from mav_detection_tpu_torch.core.config import RunConfig
from mav_detection_tpu_torch.data.synthetic import SyntheticDataset, SyntheticParams
from mav_detection_tpu_torch.eval.validator import Validator, multipart_body
from mav_detection_tpu_torch.serve import (
    YoloInferenceEngine,
    _decode_media,
    _encode_annotated,
    create_server,
    draw_rectangle,
)

torch.set_num_threads(1)

SMALL = SyntheticParams(height=120, width=160, n_frames=12)
CROSS_PX, CROSS_CONF = 2.0, 0.05


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(4242)


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address
    return f"http://{host}:{port}"


@pytest.fixture(scope="module")
def server():
    srv = create_server(port=0, device="cpu")
    url = _serve(srv)
    yield srv, url
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def engine(server):
    return server[0].engine


@pytest.fixture(scope="module")
def frames():
    ds = SyntheticDataset(params=SMALL)
    return np.stack([np.asarray(ds.get_frame(i)) for i in range(SMALL.n_frames)])


def _npz(stack):
    buf = io.BytesIO()
    np.savez(buf, frames=stack)
    return buf.getvalue()


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, data, query=""):
    body, ctype = multipart_body("video", "in.npz", data)
    req = urllib.request.Request(f"{url}/predict_video{query}", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_config_and_health(server):
    _, url = server
    status, cfg = _get(f"{url}/config")
    assert status == 200 and float(cfg["start_time"]) > 0 and cfg["media"] == ["npz"]
    assert _get(f"{url}/health") == (200, {"ok": True})
    assert _get(f"{url}/nope")[0] == 404


def test_client_roundtrip_matches_direct_inference(server, engine, frames, tmp_path):
    """The port's urllib client against the port's server: 12 frames (one
    batch of 8 and a padded tail) give the engine's boxes; the annotated npz
    comes back; a second call is served from the content-hash cache."""
    _, url = server
    media = tmp_path / "video.npz"
    np.savez(media, frames=frames)
    v = Validator(RunConfig(dataset="synthetic", mode="FLOW_FOE_YOLO"), host=url, device="cpu")
    boxes = v.get_inference(str(media), str(tmp_path / "out.npz"))
    assert boxes == engine.predict(frames)
    assert set(boxes) == {str(i) for i in range(len(frames))}
    assert any(boxes.values())
    with np.load(tmp_path / "out.npz") as z:
        assert z["frames"].shape == frames.shape
    assert v.get_inference(str(media), str(tmp_path / "out.npz")) == boxes
    cache = list((tmp_path / "bounding-boxes").glob("*.json"))
    assert len(cache) == 1 and json.loads(cache[0].read_text()) == boxes


def test_hash_keyed_boxes_survive_interleaved_jobs(server, engine, frames):
    _, url = server
    job_a, job_b = _npz(frames[:2]), _npz(frames[1:3])
    assert _post(url, job_a)[0] == _post(url, job_b)[0] == 200
    q = f"{url}/predict_video_boxes?hash={hashlib.sha1(job_a).hexdigest()}"
    assert _get(q) == (200, engine.predict(frames[:2]))
    assert _get(f"{url}/predict_video_boxes") == (200, engine.predict(frames[1:3]))
    assert _get(f"{url}/predict_video_boxes?hash={'0' * 40}")[0] == 404


def test_jobs_lru_keeps_the_last_64(server, frames):
    srv, _ = server
    for i in range(70):
        srv.store_boxes(f"h{i}", {"0": [str(i)]})
    assert len(srv.boxes_by_hash) == srv.MAX_JOBS
    assert "h5" not in srv.boxes_by_hash and srv.boxes_by_hash["h69"] == {"0": ["69"]}


@pytest.mark.parametrize("data", [b"not media", b"\x00\x00\x00\x18ftypmp42" + bytes(64)],
                         ids=["junk", "mp4"])
def test_non_npz_media_is_400_naming_the_decoder(server, data):
    _, url = server
    status, body = _post(url, data)
    assert status == 400
    assert "no video decoder" in json.loads(body)["error"]
    with pytest.raises(ValueError, match="no video decoder"):
        _decode_media(data)


def test_missing_field_and_bad_shape_are_400(server, frames):
    _, url = server
    body, ctype = multipart_body("other", "x.npz", _npz(frames[:1]))
    req = urllib.request.Request(f"{url}/predict_video", data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    assert _post(url, _npz(frames[:2, :, :, 0]))[0] == 400


def test_use_default_weights_param(server, engine, frames):
    _, url = server
    assert _post(url, _npz(frames[:2]), "?use_default_weights=True")[0] == 200
    assert _get(f"{url}/predict_video_boxes") == (200, engine.predict(frames[:2], True))


def test_parallel_predict_requests(server, engine, frames):
    """Four concurrent posts from handler threads: every answer 200, with
    the boxes of the stack posted."""
    _, url = server
    payload = _npz(frames[:3])
    results = [None] * 4

    def post(i):
        results[i] = _post(url, payload)

    ts = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert [r[0] for r in results] == [200] * 4
    assert len({r[1] for r in results}) == 1
    q = f"{url}/predict_video_boxes?hash={hashlib.sha1(payload).hexdigest()}"
    assert _get(q) == (200, engine.predict(frames[:3]))


def test_ragged_tail_and_batch_one(engine, frames):
    """n % batch != 0: the padded frames do not appear; batch 8 gives the
    box strings of batch 1."""
    out = engine.predict(frames[:3])
    assert set(out) == {"0", "1", "2"}
    one = YoloInferenceEngine(batch=1, device="cpu").predict(frames)
    assert engine.predict(frames) == one
    assert out == {k: one[k] for k in out}


def _parsed(boxes):
    return {int(k): [[float(x) for x in s.split()[1:]] for s in v] for k, v in boxes.items()}


def _assert_close_boxes(a, b):
    pa, pb = _parsed(a), _parsed(b)
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert len(pa[k]) == len(pb[k]), (k, pa[k], pb[k])
        for x, y in zip(sorted(pa[k], key=lambda r: r[1]), sorted(pb[k], key=lambda r: r[1])):
            assert abs(x[0] - y[0]) <= CROSS_CONF, (x, y)
            assert max(abs(u - v) for u, v in zip(x[1:], y[1:])) <= CROSS_PX, (x, y)


def test_jax_client_against_the_port_server(server, engine, frames, tmp_path):
    """The JAX package's client (requests) gets the port engine's boxes."""
    _, url = server
    media = tmp_path / "video.npz"
    np.savez(media, frames=frames[:5])
    v = JValidator(JRunConfig(dataset="synthetic", mode="FLOW_UV"), host=url)
    assert v._server_accepts_npz()
    assert v.get_inference(str(media), str(tmp_path / "out.npz")) == engine.predict(frames[:5])


def test_port_client_against_the_jax_server(engine, frames, tmp_path):
    """The port's urllib client gets the JAX server's boxes, within CROSS_PX
    and CROSS_CONF of the port engine's."""
    from mav_detection_tpu.serve import create_server as j_create_server

    srv = j_create_server(port=0)
    url = _serve(srv)
    try:
        media = tmp_path / "video.npz"
        np.savez(media, frames=frames[:5])
        v = Validator(RunConfig(dataset="synthetic", mode="FLOW_UV"), host=url, device="cpu")
        assert v._server_accepts_npz()
        got = v.get_inference(str(media), str(tmp_path / "out.npz"))
        assert got == srv.engine.predict(frames[:5])
        _assert_close_boxes(got, engine.predict(frames[:5]))
    finally:
        srv.shutdown()
        srv.server_close()


def test_box_outlines_bit_equal_to_cv2(rng):
    import cv2

    for _ in range(400):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        x, y = rng.uniform(-70, w + 70), rng.uniform(-70, h + 70)
        bw = float(rng.choice([0.0, rng.uniform(0, 3), rng.uniform(0, 90)]))
        bh = float(rng.choice([0.0, rng.uniform(0, 90)]))
        if rng.random() < 0.1:
            bw = -bw
        ref, got = img.copy(), img.copy()
        cv2.rectangle(ref, (int(x), int(y)), (int(x + bw), int(y + bh)), (0, 0, 255), 1)
        draw_rectangle(got, (int(x), int(y)), (int(x + bw), int(y + bh)))
        np.testing.assert_array_equal(got, ref)


def test_annotated_npz_draws_every_box(frames):
    import cv2

    boxes = {"0": ["drone 0.9 10.70 -3.20 30.00 20.50", "drone 0.8 150.5 100.1 40 40"],
             "1": [], "2": ["drone 0.7 -5.9 7.9 0.4 0.0"]}
    out = _encode_annotated(frames[:3], boxes)
    got, kind = _decode_media(out)
    assert kind == "npz"
    ref = frames[:3].copy()
    for i, strings in boxes.items():
        for s in strings:
            x, y, w, h = (float(v) for v in s.split()[2:6])
            cv2.rectangle(ref[int(i)], (int(x), int(y)), (int(x + w), int(y + h)), (0, 0, 255), 1)
    np.testing.assert_array_equal(got, ref)


def test_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        YoloInferenceEngine()
    from mav_detection_tpu_torch.cli.serve import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--port", "0"])
