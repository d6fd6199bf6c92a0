"""Each rank's exact-TP shard built on that rank, without the whole model
(``mesh_engine.build_shards``, ``tp_sharding.init_shard``,
``hf_loader.load_hf_shard``), on two gloo CPU ranks: this process and
one spawned worker (a module-scoped group; ``TorchServer`` stands up its
own).

 * Seeded: each rank's shard, over tiny and tiny-moe in bf16, int8 and
   W8A8, is bit-equal (values, dtypes, shapes, the int8 projections'
   column-major layout) to ``tp_sharding.shard_params`` of the whole
   model that ``transformer.init_params`` draws from the same seed.
 * HF checkpoints (f32 in several files, tied bf16; built in-process
   with ``transformers``): each rank's shard is bit-equal to the cut of
   ``load_hf_checkpoint``'s model, in bf16, int8 and W8A8.
 * Both, for float32 models too (``dtype="float32"``: f32 leaves, and
   int8 with W8A8 quantized from the f32 draws or checkpoint).
 * No rank builds a whole ``Transformer`` (a counting hook on
   ``Transformer.__init__`` off the meta device, and on the whole-model
   paths ``init_params`` / ``load_hf_checkpoint`` / ``hf_tree``), and a
   worker whose shard disagrees with rank 0's makes the build raise
   (``TorchServer(tp=2)`` on this route: ``tests/test_torch_mesh_server.py``).
 * ``transformer.init_params`` still draws the bits it drew before it was
   split into ``draw_leaves`` (digests of tiny and tiny-moe, tied and
   untied, recorded from the earlier implementation)."""

import dataclasses
import hashlib

import pytest
import torch

from seldon_tpu_torch.models import tp_sharding, transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.quantize import quantize_params
from seldon_tpu_torch.servers import hf_loader, mesh_engine
from torch_port_helpers import one_intra_op_thread  # noqa: F401

transformers = pytest.importorskip("transformers")

DTYPES = {"bf16": {}, "int8": dict(weight_dtype="int8"),
          "w8a8": dict(weight_dtype="int8", act_dtype="int8"),
          "f32": dict(dtype="float32"),
          "f32-w8a8": dict(dtype="float32", weight_dtype="int8",
                           act_dtype="int8")}
SEED = 7
TIMEOUT_S = 60.0
# sha256 over (name, bytes, dtype) of every leaf of init_params(cfg,
# Generator().manual_seed(3), "cpu"), from the implementation before
# draw_leaves: the refactor drew the same bits.
INIT_DIGESTS = {
    ("tiny", False):
        "3471b24e062659572f836a1353a1f2b5c72cdd044f7e5c1f3a02f67061872fbc",
    ("tiny", True):
        "16817f89839cd5e4579ae5512f8dcf5970006788062a64a2676fc89ad3452ef8",
    ("tiny-moe", False):
        "042c5b743f1d68ee3de9e2a415edeee16580c1b759b4f4ee6eea9ff1750ca8aa",
    ("tiny-moe", True):
        "92b159154f849474c993394d33a2f1e2fe8ea08399b94309a114a18103007e3a",
}


@pytest.fixture(scope="module")
def group():
    """Two CPU ranks over gloo: this process and one spawned worker."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        g = mesh_engine.spawn_group(
            mesh_engine.build_tp_mesh(2, ["cpu", "cpu"]), TIMEOUT_S)
    yield g
    g.close()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> directory of a tiny HF Llama checkpoint: "f32" in several
    files with an index (widths that tell every projection's HF row
    count apart), "tied" with tied embeddings saved in bf16."""
    out = {}
    for i, (name, tied, dtype, shard, D, F) in enumerate((
            ("f32", False, torch.float32, "60KB", 48, 160),
            ("tied", True, torch.bfloat16, None, 64, 128))):
        torch.manual_seed(i)
        hf_cfg = transformers.LlamaConfig(
            vocab_size=300, hidden_size=D, intermediate_size=F,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            tie_word_embeddings=tied, eos_token_id=2, pad_token_id=0)
        model = transformers.LlamaForCausalLM(hf_cfg).eval().to(dtype)
        path = str(tmp_path_factory.mktemp(f"hf-{name}"))
        model.save_pretrained(path, safe_serialization=True,
                              **({"max_shard_size": shard} if shard else {}))
        out[name] = path
    return out


class _Rank:
    """A rank's coordinates in the two-rank group (``shard_params``)."""

    def __init__(self, rank):
        self.rank, self.world = rank, 2


def _named(params) -> dict:
    return {k: t.detach() for k, t in list(params.named_parameters())
            + list(params.named_buffers())}


def _worker_shard(worker):
    """Run on the worker: its shard's leaves."""
    return {k: t.clone() for k, t in _named(worker.params).items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int8 else t.contiguous().view(torch.uint8)


def _assert_cut(whole, cfg, rank, got: dict, what):
    """``got`` (a rank's leaves) is rank ``rank``'s cut of ``whole``, bit
    for bit; a 2-D leaf keeps the cut's layout (column-major int8)."""
    want = _named(tp_sharding.shard_params(_Rank(rank), cfg, whole))
    assert got.keys() == want.keys(), (what, got.keys() ^ want.keys())
    for k, w in want.items():
        g = got[k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (what, k)
        assert torch.equal(_bits(g), _bits(w)), f"{what}: {k} differs"
        if g.dim() == 2 and min(g.shape) > 1:
            assert g.stride() == w.stride(), (what, k)


def _whole(cfg, source):
    if source[0] == "seed":
        whole = transformer.init_params(
            cfg, torch.Generator().manual_seed(source[1]), "cpu")
    else:
        whole = hf_loader.load_hf_checkpoint(source[1], "cpu",
                                             cfg.dtype)[0]
    return quantize_params(whole) if cfg.weight_dtype == "int8" else whole


def _check_build(group, cfg, source, what):
    mine = mesh_engine.build_shards(group, cfg, source)
    theirs = group.run(f"{__name__}:_worker_shard")[0]
    whole = _whole(cfg, source)
    _assert_cut(whole, cfg, 0, _named(mine), f"{what} rank 0")
    _assert_cut(whole, cfg, 1, theirs, f"{what} rank 1")


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_seeded_shards_equal_the_cut(group, preset, dtype):
    cfg = dataclasses.replace(get_config(preset), **DTYPES[dtype])
    _check_build(group, cfg, ("seed", SEED), f"{preset}/{dtype}")


@pytest.mark.parametrize("name", ["f32", "tied"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_hf_shards_equal_the_cut(group, checkpoints, name, dtype):
    path = checkpoints[name]
    cfg = dataclasses.replace(hf_loader.checkpoint_config(path),
                              **DTYPES[dtype])
    _check_build(group, cfg, ("hf", path), f"{name}/{dtype}")


def test_hf_shard_reads_its_rows_alone(checkpoints, monkeypatch):
    """A rank's projection leaves arrive from the checkpoint at their
    shard width: only that rank's rows of HF's [out, in] tensors are
    read and converted (each width below belongs to one kind of
    tensor in the "f32" checkpoint)."""
    path = checkpoints["f32"]
    cfg = hf_loader.checkpoint_config(path)
    D, F, kv = cfg.d_model, cfg.d_ff, cfg.n_kv_heads * cfg.head_dim
    shapes = []
    convert = hf_loader._convert

    def seen(tag, arr, transpose, norm):
        shapes.append(tuple(arr.shape))
        return convert(tag, arr, transpose, norm)

    monkeypatch.setattr(hf_loader, "_convert", seen)
    shard, _ = hf_loader.load_hf_shard(path, "cpu", 1, 2)
    L = cfg.n_layers
    assert shapes.count((F, D)) == 0  # gate / up never whole
    assert shapes.count((F // 2, D)) == 2 * L
    assert shapes.count((kv // 2, D)) == 2 * L  # k / v halves
    assert shapes.count((kv, D)) == L  # q's half (H*Dh / 2 = Hkv*Dh)
    assert shapes.count((D, F)) == L  # w_down, replicated
    assert shard.blocks[0].wq.shape[-1] == cfg.n_heads * cfg.head_dim // 2


def _hook_builds(worker=None):
    """Count whole-model builds in this process: a Transformer made off
    the meta device, and calls of the whole-model paths."""
    global _BUILDS, _UNHOOK
    _BUILDS = []
    saved = [(transformer.Transformer, "__init__"),
             (transformer, "init_params"), (hf_loader, "load_hf_checkpoint"),
             (hf_loader, "hf_tree")]
    originals = [getattr(o, n) for o, n in saved]

    def counted(name, fn):
        def wrap(*a, **k):
            _BUILDS.append(name)
            return fn(*a, **k)
        return wrap

    init = originals[0]

    def tf_init(self, cfg, device=None):
        if str(device) != "meta":
            _BUILDS.append("Transformer")
        init(self, cfg, device)

    transformer.Transformer.__init__ = tf_init
    for (o, n), fn in zip(saved[1:], originals[1:]):
        setattr(o, n, counted(n, fn))

    def unhook():
        for (o, n), fn in zip(saved, originals):
            setattr(o, n, fn)

    _UNHOOK = unhook


def _builds(worker=None):
    _UNHOOK()
    return list(_BUILDS)


@pytest.mark.parametrize("source", ["seed", "hf"])
def test_no_rank_builds_the_whole_model(group, checkpoints, source):
    cfg = get_config("tiny")
    src = ("seed", SEED)
    if source == "hf":
        src = ("hf", checkpoints["f32"])
        cfg = hf_loader.checkpoint_config(src[1])
    group.run(f"{__name__}:_hook_builds")
    _hook_builds()
    try:
        mesh_engine.build_shards(group, cfg, src)
    finally:
        mine = _builds()
        theirs = group.run(f"{__name__}:_builds")[0]
    assert mine == [] and theirs == [], (mine, theirs)


def test_a_disagreeing_shard_raises(group, monkeypatch):
    """A worker whose replicated leaves differ from rank 0's (here: rank 0
    seeded apart from the worker) fails the build."""
    cfg = get_config("tiny")
    real = mesh_engine.build_rank_shard

    def other_seed(cfg, source, device, rank, tp):
        return real(cfg, ("seed", SEED + 1), device, rank, tp)

    monkeypatch.setattr(mesh_engine, "build_rank_shard", other_seed)
    with pytest.raises(RuntimeError, match="rank 1's shard disagrees"):
        mesh_engine.build_shards(group, cfg, ("seed", SEED))
    monkeypatch.undo()
    mesh_engine.build_shards(group, cfg, ("seed", SEED))


@pytest.mark.parametrize("preset,tied", sorted(INIT_DIGESTS))
def test_init_params_bits_unchanged(preset, tied):
    cfg = dataclasses.replace(get_config(preset), tie_embeddings=tied)
    p = transformer.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    h = hashlib.sha256()
    for n, t in list(p.named_parameters()) + list(p.named_buffers()):
        h.update(n.encode())
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
        h.update(str(t.dtype).encode())
    assert h.hexdigest() == INIT_DIGESTS[(preset, tied)]



def test_projection_gemm_is_card_only():
    """The pinned projection GEMM (``ops/lt_gemm``) takes bf16 CUDA
    tensors only and loads nothing until it runs on the card; on the CPU
    the projections stay ``x @ W`` (the card's equality with the full
    product is tests/test_torch_mesh_cuda.py's)."""
    from seldon_tpu_torch.ops import lt_gemm

    x = torch.ones(2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 CUDA"):
        lt_gemm.matmul(x, torch.ones(64, 8, dtype=torch.bfloat16))
    cfg = get_config("tiny")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    before = lt_gemm.launches
    transformer.forward(params, torch.arange(3, 19)[None], cfg)
    assert lt_gemm.launches == before and lt_gemm._lt is None
