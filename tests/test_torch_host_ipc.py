"""The port's host IPC bindings (host/shm.py, host/frame_ring.py,
host/iox2.py and middleware/transport.py::Iox2Transport) against the JAX
package's, on the CPU.

Both packages bind the same library: the one the port builds with g++ from
host/src (its path is put at the front of the JAX package's _LIB_PATHS, as
tests/test_iox2.py puts its cmake build there). Every segment and service
name carries this process's pid: the tier-1 workers share /dev/shm, the
state segment is opened without O_EXCL and unlinked by its owner, and JAX's
tests/test_iox2.py uses the fixed VisionPilot/* service names. What is held:
- the ctypes structs: size and every field offset equal to JAX's structs
  and to the C++ compiler's (a probe built with the library's flags);
- every payload byte for byte, in both directions between the packages, and
  across a second process.
"""
import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from autoware_vision_pilot_tpu.host import frame_ring as jring
from autoware_vision_pilot_tpu.host import iox2 as jiox2
from autoware_vision_pilot_tpu.host import shm as jshm

from autoware_vision_pilot_tpu_torch.host import frame_ring as tring
from autoware_vision_pilot_tpu_torch.host import iox2 as tiox2
from autoware_vision_pilot_tpu_torch.host import shm as tshm
from autoware_vision_pilot_tpu_torch.middleware import transport as ttransport

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
PID = os.getpid()


@pytest.fixture(scope="module")
def library():
    """The port's build, also handed to the JAX bindings."""
    lib = tshm.build()
    if lib not in jshm._LIB_PATHS:
        jshm._LIB_PATHS.insert(0, lib)
    return lib


def name(kind):
    return f"/avp_torch_{kind}_{PID}"


def seeded_state(struct, seed):
    """Every field of a VisionPilotStateStruct from a seed (seq left 0)."""
    rng = np.random.default_rng(seed)
    s = struct()
    for field, ctype in struct._fields_[1:]:
        if ctype is ctypes.c_bool:
            setattr(s, field, bool(rng.integers(0, 2)))
        elif ctype in (ctypes.c_int, ctypes.c_uint64):
            setattr(s, field, int(rng.integers(0, 1 << 20)))
        else:
            setattr(s, field, float(rng.normal(0.0, 50.0)))
    return s


def payload(struct_obj):
    """The bytes after the seq word."""
    return bytes(struct_obj)[8:]


def test_library_is_built_from_the_sources(library, tmp_path, monkeypatch):
    """g++ builds libavp_host.so into build/torch_kernels/ with the digest of
    the sources, the headers and the flags beside it; a later call keeps it;
    a source g++ refuses raises with its stderr."""
    assert library == tshm.LIBRARY and library.parent == REPO / "build" / "torch_kernels"
    assert library.with_suffix(".sha256").read_text() == tshm._digest()
    mtime = library.stat().st_mtime_ns
    assert tshm.build() == library and library.stat().st_mtime_ns == mtime
    assert tshm._load_lib().avp_shm_state_size() == ctypes.sizeof(tshm.VisionPilotStateStruct)
    broken = tmp_path / "host"
    (broken / "src").mkdir(parents=True)
    (broken / "include").mkdir()
    (broken / "src" / "capi.cpp").write_text("int main( {\n")
    monkeypatch.setattr(tshm, "HOST", broken)
    monkeypatch.setattr(tshm, "SOURCES", (broken / "src" / "capi.cpp",))
    monkeypatch.setattr(tshm, "LIBRARY", tmp_path / "lib" / "libavp_host.so")
    monkeypatch.setattr(tshm, "BUILD_DIR", tmp_path / "lib")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*capi.cpp"):
        tshm.build()


# (port struct, JAX struct, C++ type, header)
STRUCTS = [
    (tshm.VisionPilotStateStruct, jshm.VisionPilotStateStruct, "avp::host::VisionPilotState",
     "avp/shared_state.hpp"),
    (tring.FrameHeaderStruct, jring.FrameHeaderStruct, "avp::host::FrameHeader",
     "avp/frame_ring.hpp"),
    (tiox2.RawFrameStruct, jiox2.RawFrameStruct, "avp::iox2msg::RawFrame",
     "transmission_data.hpp"),
    (tiox2.CIPOMessageStruct, jiox2.CIPOMessageStruct, "avp::iox2msg::CIPOMessage",
     "transmission_data.hpp"),
]


def test_struct_layouts_match_jax_and_the_compiler(tmp_path):
    lines = []
    for port, _, cpp, _ in STRUCTS:
        lines.append(f'std::printf("%zu\\n", sizeof({cpp}));')
        for field, _ in port._fields_:
            lines.append(f'std::printf("%zu\\n", offsetof({cpp}, {field}));')
    headers = sorted({h for *_, h in STRUCTS})
    probe = tmp_path / "probe.cpp"
    probe.write_text("#include <cstddef>\n#include <cstdio>\n" +
                     "".join(f'#include "{h}"\n' for h in headers) +
                     "int main() {\n" + "\n".join(lines) + "\n}\n")
    exe = tmp_path / "probe"
    subprocess.run(["g++", "-std=c++20", "-Wno-invalid-offsetof",
                    f"-I{REPO / 'host' / 'include'}",
                    f"-I{REPO / 'host' / 'middleware' / 'iox2'}", str(probe), "-o", str(exe)],
                   check=True, capture_output=True)
    cpp = iter(int(v) for v in subprocess.run([str(exe)], check=True, capture_output=True,
                                              text=True).stdout.split())
    for port, jax_struct, cname, _ in STRUCTS:
        assert port._fields_ == jax_struct._fields_, cname
        assert ctypes.sizeof(port) == ctypes.sizeof(jax_struct) == next(cpp), cname
        for field, _ in port._fields_:
            off = getattr(port, field).offset
            assert off == getattr(jax_struct, field).offset == next(cpp), (cname, field)


def test_shm_state_between_the_packages(library):
    """Port publisher -> JAX reader and JAX publisher -> port reader, every
    field byte for byte, 20 updates each; the seqlock's seq even."""
    for pub_cls, rd_cls, struct, seed in [
            (tshm.SharedStatePublisher, jshm.SharedStateReader, tshm.VisionPilotStateStruct, 1),
            (jshm.SharedStatePublisher, tshm.SharedStateReader, jshm.VisionPilotStateStruct, 2)]:
        with pub_cls(name("state")) as pub, rd_cls(name("state")) as rd:
            for i in range(20):
                s = seeded_state(struct, seed * 100 + i)
                pub.publish(s)
                out = rd.read()
                assert payload(out) == payload(s) and out.seq == 2 * (i + 1)


READER = """
import json, sys
from autoware_vision_pilot_tpu_torch.host.shm import SharedStateReader
with SharedStateReader(sys.argv[1]) as rd:
    print(bytes(rd.read()).hex())
"""


def test_shm_state_read_in_a_second_process(library):
    """The port's reader in another process sees the port publisher's
    bytes."""
    s = seeded_state(tshm.VisionPilotStateStruct, 3)
    with tshm.SharedStatePublisher(name("state2")) as pub:
        pub.publish(s)
        out = subprocess.run([sys.executable, "-c", READER, name("state2")], cwd=REPO,
                             capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert bytes.fromhex(out.stdout.strip())[8:] == payload(s)


def frames(n, hw, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def test_frame_ring_between_the_packages(library):
    """12 seeded frames each way through a 4-slot ring, byte for byte with
    their headers; nothing to read before the first publish, nothing new
    after the last read, and frame number 0 stays unseen."""
    for owner, reader, seed in [(tring.FrameRing, jring.FrameRing, 4),
                                (jring.FrameRing, tring.FrameRing, 5)]:
        with owner(name("ring"), owner=True, slot_bytes=48 * 64 * 3) as ring, \
                reader(name("ring")) as rd:
            assert rd.read_latest() is None
            assert ring.publish(np.zeros((48, 64, 3), np.uint8), 0, timestamp_ns=1)
            assert rd.read_latest() is None
            for i, f in enumerate(frames(12, (48, 64), seed), start=1):
                assert ring.publish(f, i, timestamp_ns=1000 + i)
                got, hdr = rd.read_latest(last_seen=i - 1)
                np.testing.assert_array_equal(got, f)
                assert (hdr.frame_number, hdr.height, hdr.width, hdr.channels,
                        hdr.timestamp_ns) == (i, 48, 64, 3, 1000 + i)
                assert rd.read_latest(last_seen=i) is None
            assert not ring.publish(np.zeros((49, 64, 3), np.uint8), 13)  # past the slot


def test_iox2_service_between_the_packages(library):
    """The port's service as publisher and JAX's as subscriber, and the
    reverse: frames byte for byte with their headers, CIPO messages in
    order, the oldest dropped and counted when the reader falls behind."""
    svc = f"AVPTorch{PID}/Frames"
    for pub_mod, sub_mod, seed in [(tiox2, jiox2, 6), (jiox2, tiox2, 7)]:
        with pub_mod.Iox2Service(svc, pub_mod.RawFrameStruct, n_slots=2, create=True) as pub, \
                sub_mod.Iox2Service(svc, sub_mod.RawFrameStruct, timeout_ms=1000) as sub:
            for i, f in enumerate(frames(3, (72, 128), seed)):
                pub_mod.publish_frame(pub, f, frame_id=10 + i, source_id=2)
                got, hdr = sub_mod.receive_frame(sub)
                np.testing.assert_array_equal(got, f)
                assert (hdr.frame_id, hdr.width, hdr.height, hdr.channels, hdr.step,
                        hdr.source_id) == (10 + i, 128, 72, 3, 384, 2)
            assert sub.receive() is None
    svc = f"AVPTorch{PID}/Cipo"
    for pub_mod, sub_mod in [(tiox2, jiox2), (jiox2, tiox2)]:
        with pub_mod.Iox2Service(svc, pub_mod.CIPOMessageStruct, n_slots=4, create=True) as pub, \
                sub_mod.Iox2Service(svc, sub_mod.CIPOMessageStruct, timeout_ms=1000) as sub:
            sent = []
            for i in range(3):
                m = pub.loan()
                m.frame_id, m.exists, m.distance_m, m.track_id = 100 + i, True, 2.5 * i, i
                sent.append(bytes(m))
                pub.publish()
            assert [bytes(sub.receive()) for _ in range(3)] == sent and sub.receive() is None
            for i in range(10):
                pub.loan().frame_id = 200 + i
                pub.publish()
            seen = []
            while (m := sub.receive()) is not None:
                seen.append(m.frame_id)
            assert seen[-1] == 209 and len(seen) <= 4 and seen == sorted(seen)
            assert sub.samples_lost >= 6 and sub.latest_seq() == 13


def test_iox2_transport_on_services_of_its_own(library, monkeypatch):
    """Iox2Transport with its topic -> service map pointed at this test's
    names (never VisionPilot/*): a CIPO dict and a frame through the port's
    transport arrive as JAX's transport delivers them."""
    topics = {"raw_frames": f"AVPTorch{PID}/RawFrames", "cipo": f"AVPTorch{PID}/CIPO"}
    monkeypatch.setattr(ttransport.Iox2Transport, "_TOPICS", topics)
    from autoware_vision_pilot_tpu.middleware import transport as jtransport
    monkeypatch.setattr(jtransport.Iox2Transport, "_TOPICS", topics)
    msg = {"frame_id": 5, "exists": True, "distance_m": 12.5, "velocity_ms": -1.0,
           "track_id": 3, "class_id": 1, "confidence": 0.75, "num_tracked_objects": 4}
    frame = frames(1, (90, 160), 8)[0]
    got = {}
    for mod in (ttransport, jtransport):
        tx = mod.make_transport("iox2", publish_topics=["/cipo", "raw_frames"])
        rx = mod.make_transport("iox2")
        try:
            rx.subscribe("/cipo", lambda d, mod=mod: got.setdefault((mod, "cipo"), d))
            rx.subscribe("raw_frames", lambda f, mod=mod: got.setdefault((mod, "frame"), f))
            tx.publish("/cipo", msg)
            tx.publish("raw_frames", frame)
            rx.spin_once(timeout=1.0)
            rx.spin_once(timeout=1.0)
        finally:
            tx.close()
            rx.close()
    port, ref = got[(ttransport, "cipo")], got[(jtransport, "cipo")]
    assert port.keys() == ref.keys()
    for k in port:
        if "timestamp" not in k:
            assert port[k] == ref[k], k
    assert {k: port[k] for k in msg} == {k: pytest.approx(v) for k, v in msg.items()}
    np.testing.assert_array_equal(got[(ttransport, "frame")], frame)
    np.testing.assert_array_equal(got[(jtransport, "frame")], frame)
    with pytest.raises(ValueError, match="no service"):
        ttransport.Iox2Transport(publish_topics=["/lanes"])
