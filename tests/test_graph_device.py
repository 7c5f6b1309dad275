"""Device-path multi-instance comm graphs (VERDICT r2 #5): a RenderGraph
whose vectorizable nodes run the device vector engine must null-match the
all-shadow graph message-for-message and gmem-page-for-page.

The device decomposition: control runs on the host in LOCKSTEP (each
node's @block interpreted by its golden executor against the shared
CommWorld, in host processing order — so bus/gmem exchanges are identical
to the shadow graph by construction), then each node's sample-rate
compute rides its vectorized kernel (ref DspJsfxMessageBus.cpp:529,609
block-resolved delivery; docs/DSP-JSFX-Communication.md)."""
import numpy as np
import pytest

from zorak_tpu.catalog import discover
from zorak_tpu.ir import compile_plugin_source
from zorak_tpu.runtime.graph import RenderGraph


def _ipc_programs():
    specs = {s.slug: s for s in discover("/root/reference")}
    if "IPCProbeA" not in specs or "IPCProbeB" not in specs:
        pytest.skip("reference catalog not available")
    return specs["IPCProbeA"].load_program(), specs["IPCProbeB"].load_program()


def _build(prefer, progs, n):
    pa, pb = progs
    g = RenderGraph(block_size=64, prefer=prefer)
    g.add("tx", pa, sliders={0: 0.0})            # Sender
    g.add("rx", pb, sliders={0: 1.0})            # Receiver
    g.init_all()
    rng = np.random.RandomState(5)
    x = (rng.randn(2, n) * 0.1).astype(np.float32)
    outs = g.run({"tx": x, "rx": x})
    return g, outs


class TestIPCProbeGraphDevice:
    def test_device_graph_matches_shadow(self):
        progs = _ipc_programs()
        n = 64 * 6
        gs, outs_s = _build("shadow", progs, n)
        gd, outs_d = _build("auto", progs, n)
        # both IPCProbe roles must have taken the vector path
        assert gd.node_engines == ["tpu-vector", "tpu-vector"], \
            gd.spec_errors
        # audio: the receiver's debug tone tracks rx_count — nonzero and
        # bit-equal to the shadow graph
        assert np.abs(outs_s["rx"]).max() > 0.0
        assert np.array_equal(outs_s["rx"], outs_d["rx"])
        assert np.array_equal(outs_s["tx"], outs_d["tx"])
        # message-for-message: sender seq and receiver rx_* evolved
        # identically (the lockstep trajectory IS the shadow @block)
        for i in range(2):
            vs = gs.plugins[i].state.V
            vd = gd.plugins[i].state.V
            for name in ("seq", "rx_seq", "rx_src", "rx_count",
                         "last_peer_count", "iid"):
                assert vs.get(name, 0.0) == vd.get(name, 0.0), (i, name)
        assert gs.plugins[0].state.V["seq"] == 6.0
        assert gs.plugins[1].state.V["rx_count"] == 6.0
        # gmem-page-for-gmem-page across the shared segment
        seg_s = gs.hosts[0].attached_gmem
        seg_d = gd.hosts[0].attached_gmem
        assert seg_s is not None and seg_d is not None
        assert np.array_equal(seg_s.cells, seg_d.cells)
        assert seg_s.cells[:5].any()   # the probe actually wrote meters

    def test_mixed_graph_shadow_fallback_nodes(self):
        # a node the vectorizer rejects (data-dependent voice loop) runs
        # its shadow inline in the SAME lockstep; comm still matches
        progs = _ipc_programs()
        hard = compile_plugin_source(
            "@init\nn = 0;\n@sample\n"
            "k = abs(spl0) * 4;\ni = 0;\nacc = 0;\n"
            "while (i < k) ( acc += 0.1; i += 1; );\n"
            "spl0 = spl0 + acc * 0.001;\nspl1 = spl1;\n")
        n = 64 * 4
        outs = {}
        engines = {}
        for prefer in ("shadow", "auto"):
            g = RenderGraph(block_size=64, prefer=prefer)
            g.add("tx", progs[0], sliders={0: 0.0})
            g.add("rx", progs[1], sliders={0: 1.0})
            g.add("hard", hard)
            g.init_all()
            rng = np.random.RandomState(5)
            x = (rng.randn(2, n) * 0.1).astype(np.float32)
            outs[prefer] = g.run({"tx": x, "rx": x, "hard": x})
            engines[prefer] = list(g.node_engines)
        assert engines["auto"][0] == "tpu-vector"
        assert engines["auto"][2] == "cpu-shadow"
        for name in ("tx", "rx", "hard"):
            assert np.array_equal(outs["shadow"][name], outs["auto"][name]), \
                name


class TestCoupledNodesInGraph:
    """Comm-free coupled kernels (device @block fused in the scan) are
    graph-legal (VERDICT r3 #6): the node's control neither reads nor
    writes the shared world, so its fused device render interleaves with
    the lockstep of the comm-using nodes."""

    COUPLED_SRC = """\
@init
g = 1;
@block
avg = acc / max(samplesblock, 1);
g = 1 / (1 + avg*avg);
acc = 0;
@sample
acc += abs(spl0);
spl0 = spl0 * g;
spl1 = spl1 * g;
"""

    def test_coupled_node_rides_device_beside_ipc_pair(self):
        progs = _ipc_programs()
        coupled = compile_plugin_source(self.COUPLED_SRC)
        n = 64 * 6
        res = {}
        for prefer in ("shadow", "auto"):
            g = RenderGraph(block_size=64, prefer=prefer)
            g.add("tx", progs[0], sliders={0: 0.0})
            g.add("rx", progs[1], sliders={0: 1.0})
            g.add("meter", coupled)
            g.init_all()
            rng = np.random.RandomState(5)
            x = (rng.randn(2, n) * 0.3).astype(np.float32)
            res[prefer] = (g, g.run({"tx": x, "rx": x, "meter": x}))
        gd = res["auto"][0]
        assert gd.node_engines == ["tpu-vector"] * 3, gd.spec_errors
        assert gd.kernels[2] is not None and gd.kernels[2].coupled
        for name in ("tx", "rx", "meter"):
            assert np.array_equal(res["shadow"][1][name],
                                  res["auto"][1][name]), name
        assert np.abs(res["auto"][1]["meter"]).max() > 0.0
        # the coupled node's final control state wrote back
        vs = res["shadow"][0].plugins[2].state.V
        vd = gd.plugins[2].state.V
        # XLA may contract mul+add to FMA inside the fused @block scan —
        # a 1-ulp f64 wobble vs the golden's strict IEEE order (same
        # allowance as tests/test_devexec.py)
        assert abs(vs["g"] - vd["g"]) <= 1e-12
        assert abs(vs["acc"] - vd["acc"]) <= 1e-12
        # comm world evolved identically around it
        assert res["shadow"][0].plugins[0].state.V["seq"] \
            == gd.plugins[0].state.V["seq"]

    LOCKSTEP_SRC = """\
slider1:0<0,7,1>Slot
@init
gmem_attach("lockbus");
slot = slider1;
@block
avg = acc / max(samplesblock, 1);
peer = gmem[1 - slot];
gmem[slot] = avg;
g = 1 / (1 + 4 * peer);
acc = 0;
@sample
acc += abs(spl0);
spl0 = spl0 * g;
spl1 = spl1 * g;
"""

    def test_gmem_coupled_pair_joint_lockstep_scan(self):
        # TWO coupled nodes exchanging through one gmem segment: the
        # joint scan threads the segment through both device @blocks in
        # node order, reproducing the all-shadow graph's sequential
        # same-block visibility (a@block writes gmem[0], b@block READS
        # it the same block — a one-block-late scheme would diverge)
        prog = compile_plugin_source(self.LOCKSTEP_SRC)
        n = 64 * 6 + 17     # exercise the remainder step too
        res = {}
        for prefer in ("shadow", "auto"):
            g = RenderGraph(block_size=64, prefer=prefer)
            g.add("a", prog, sliders={0: 0.0})
            g.add("b", prog, sliders={0: 1.0})
            g.init_all()
            rng = np.random.RandomState(3)
            x = (rng.randn(2, n) * 0.4).astype(np.float32)
            res[prefer] = (g, g.run({"a": x, "b": x}))
        gd = res["auto"][0]
        assert gd.node_engines == ["tpu-lockstep", "tpu-lockstep"], \
            (gd.node_engines, gd.spec_errors)
        for name in ("a", "b"):
            assert np.array_equal(res["shadow"][1][name],
                                  res["auto"][1][name]), name
        assert np.abs(res["auto"][1]["a"]).max() > 0.0
        # the shared segment matched cell-for-cell after writeback
        seg_s = res["shadow"][0].hosts[0].attached_gmem
        seg_d = res["auto"][0].hosts[0].attached_gmem
        assert seg_s is not None and seg_d is not None
        assert seg_s.cells[:2].any()
        assert np.array_equal(seg_s.cells, seg_d.cells)
        # per-node control state wrote back (FMA wobble allowance as in
        # the coupled-node test above)
        for i in range(2):
            vs = res["shadow"][0].plugins[i].state.V
            vd = res["auto"][0].plugins[i].state.V
            for k in ("g", "peer", "avg", "acc"):
                assert abs(vs[k] - vd[k]) <= 1e-12, (i, k, vs[k], vd[k])

    def test_gmem_segment_shared_with_host_node_demotes(self):
        # an UNCOUPLED node reading the same segment runs its @block on
        # the host per block (phase 1) — the joint scan cannot include
        # it, so the coupled members fall back rather than reorder gmem
        prog = compile_plugin_source(self.LOCKSTEP_SRC)
        watcher = compile_plugin_source(
            "@init\ngmem_attach(\"lockbus\");\n"
            "@block\nw = gmem[0];\n@sample\nspl0 = spl0 * (1 + 0*w);\n"
            "spl1 = spl1;\n")
        res = {}
        n = 64 * 4
        for prefer in ("shadow", "auto"):
            g = RenderGraph(block_size=64, prefer=prefer)
            g.add("a", prog, sliders={0: 0.0})
            g.add("w", watcher)
            g.init_all()
            rng = np.random.RandomState(4)
            x = (rng.randn(2, n) * 0.3).astype(np.float32)
            res[prefer] = (g, g.run({"a": x, "w": x}))
        gd = res["auto"][0]
        assert gd.node_engines[0] == "cpu-shadow", gd.node_engines
        assert "host-path" in gd.spec_errors.get("a", "")
        for name in ("a", "w"):
            assert np.array_equal(res["shadow"][1][name],
                                  res["auto"][1][name]), name

    def test_coupled_node_touching_bus_rides_lockstep(self):
        # round 5 (VERDICT r4 #5): a coupled @block's bus traffic now
        # stages through the joint lockstep scan instead of demoting —
        # see tests/test_graph_msg_lockstep.py for the delivery-order
        # coverage; here just assert the routing upgrade
        src = self.COUPLED_SRC + "\n"
        src = src.replace("acc = 0;",
                          "acc = 0;\nmsg_send(1, 1, g, 0, 0, 0);")
        prog = compile_plugin_source(src)
        g = RenderGraph(block_size=64, prefer="auto")
        g.add("node", prog)
        g.init_all()
        assert g.node_engines[0] == "tpu-lockstep", \
            (g.node_engines, g.spec_errors)


class TestRealCatalogPairs:
    """The reference's real cross-instance sessions on the device graph:
    3DPannerManager <-> 3DPanner gmem metadata broadcast (the Manager
    vectorizes; the Panner's gated FDN runs shadow inline in the same
    lockstep) and a CMD pair over its gmem-linked buses."""

    def _pair(self, slug_a, slug_b, n, block=64, sliders_a=None,
              sliders_b=None):
        specs = {s.slug: s for s in discover("/root/reference")}
        if slug_a not in specs or slug_b not in specs:
            pytest.skip("reference catalog not available")
        pa = specs[slug_a].load_program()
        pb = specs[slug_b].load_program()
        res = {}
        for prefer in ("shadow", "auto"):
            g = RenderGraph(block_size=block, prefer=prefer)
            g.add("a", pa, sliders=sliders_a)
            g.add("b", pb, sliders=sliders_b)
            g.init_all()
            rng = np.random.RandomState(9)
            x = (rng.randn(2, n) * 0.2).astype(np.float32)
            outs = g.run({"a": x, "b": x})
            res[prefer] = (g, outs)
        return res

    def test_manager_panner_metadata_broadcast(self):
        res = self._pair("3DPannerManager", "3DPanner", 64 * 4)
        gd = res["auto"][0]
        # Manager vectorizes; the Panner's @sample resists (gated FDN) —
        # shadow inline in the same lockstep
        assert gd.node_engines[0] == "tpu-vector", gd.spec_errors
        for name in ("a", "b"):
            assert np.array_equal(res["shadow"][1][name],
                                  res["auto"][1][name]), name
        # the shared scene segment matched cell-for-cell
        seg_s = res["shadow"][0].hosts[0].attached_gmem
        seg_d = res["auto"][0].hosts[0].attached_gmem
        if seg_s is not None and seg_d is not None:
            assert np.array_equal(seg_s.cells, seg_d.cells)
        # per-node final vars match (skip handle-valued string vars:
        # handle NUMBERS are allocation-order artifacts, text equality is
        # what the engine persists)
        for i in range(2):
            vs = res["shadow"][0].plugins[i].state.V
            vd = res["auto"][0].plugins[i].state.V
            for k, v in vs.items():
                if k in vd and not (v != v):
                    dv = vd[k]
                    if v >= (1 << 40) or dv >= (1 << 40):
                        continue   # string handles
                    assert v == dv, (i, k, v, dv)

    def test_cmd_pair_gmem_buses(self):
        # CMD's @block is COUPLED (it logs audio-derived data) and its
        # comm is pure gmem (drain_messages is a stub — ref
        # CrossMixDeclutter.jsfx:282-286: "Message traffic is disabled in
        # the CMD hot path"), so the pair rides the joint gmem-lockstep
        # scan: both device @blocks + fused sample segments in ONE
        # lax.scan threading the shared TurnPulse bus segment in node
        # order — bit-matching the all-shadow graph's heartbeat/slot
        # handshake (VERDICT r3 #6).
        res = self._pair("CMD", "CMD", 64 * 4)
        gd = res["auto"][0]
        assert gd.node_engines == ["tpu-lockstep", "tpu-lockstep"], \
            (gd.node_engines, gd.spec_errors)
        for name in ("a", "b"):
            assert np.array_equal(res["shadow"][1][name],
                                  res["auto"][1][name]), name
        # the shared bus segment (slot heartbeats, published band
        # energies, piston state) matched — strict compare on the
        # header/slot structure; published float payloads carry the same
        # FMA wobble allowance as device @block vars (the synthetic
        # lockstep test above holds the mechanism to BIT equality)
        seg_s = res["shadow"][0].hosts[0].attached_gmem
        seg_d = res["auto"][0].hosts[0].attached_gmem
        assert seg_s is not None and seg_d is not None
        assert seg_s.cells.any()
        np.testing.assert_allclose(seg_d.cells, seg_s.cells,
                                   rtol=1e-12, atol=1e-12)
