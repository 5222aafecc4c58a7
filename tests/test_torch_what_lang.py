"""The port's spec language and spec compiler against the JAX package:
every copied builtin spec text parses to the reference AST with the port's
vocabulary (``tpu`` -> ``cuda``, ``jnp.*`` -> ``torch.*``) and survives a
print/reparse round trip; the registry holds the harnesses of the slice."""
import dataclasses

import pytest

from repro.core import what_lang as JW
from repro_torch import lilac
from repro_torch.core import what_lang as TW


def _port_vocabulary(spec: JW.Spec) -> JW.Spec:
    def plat(names):
        return tuple("cuda" if n == "tpu" else n for n in names)

    def name(n):
        return "torch." + n[4:] if n.startswith("jnp.") else n

    harnesses = tuple(
        dataclasses.replace(h, name=name(h.name), platforms=plat(h.platforms),
                            default_for=plat(h.default_for))
        for h in spec.harnesses)
    return dataclasses.replace(spec, harnesses=harnesses)


@pytest.mark.parametrize("family", sorted(JW.BUILTIN_SPECS))
def test_builtin_spec_parses_to_reference_ast(family):
    ref = _port_vocabulary(JW.parse_spec(JW.BUILTIN_SPECS[family]))
    got = TW.parse_spec(TW.BUILTIN_SPECS[family])
    # the two packages' AST classes differ; their field values must not
    assert [dataclasses.astuple(h) for h in got.harnesses] \
        == [dataclasses.astuple(h) for h in ref.harnesses]
    # the printed form of an expression names its operators (astuple of
    # Add and Mul would agree)
    assert [str(c) for c in got.computations] \
        == [str(c) for c in ref.computations]


@pytest.mark.parametrize("family", sorted(TW.BUILTIN_SPECS))
def test_builtin_spec_print_reparse_round_trip(family):
    spec = TW.parse_spec(TW.BUILTIN_SPECS[family])
    assert TW.parse_spec(str(spec)) == spec


def test_default_platforms_are_cpu_and_cuda():
    h = TW.parse_harness("HARNESS x.y implements spmv_csr")
    assert h.platforms == ("cpu", "cuda")
    assert str(h) == "HARNESS x.y implements spmv_csr"


def test_registry_holds_the_slice():
    names = {c: [h.name for h in lilac.REGISTRY.harnesses_for(c)]
             for c in ("spmv_csr", "spmv_coo", "spmv_ell", "spmv_jds",
                       "spmm_csr", "moe_ffn")}
    assert names["spmv_csr"] == ["torch.segment", "torch.ell", "torch.bcsr",
                                 "torch.dense", "cuda.ell", "cuda.bcsr"]
    assert names["spmv_coo"] == names["spmv_csr"]
    assert names["spmv_ell"] == names["spmv_jds"] == ["torch.ell", "cuda.ell"]
    assert names["spmm_csr"] == ["torch.segment", "torch.bcsr", "cuda.bcsr"]
    # the dense baseline registers after the kernel's block
    assert names["moe_ffn"] == ["torch.capacity", "cuda.gmm", "dense"]
    reg = lilac.REGISTRY
    assert reg.default_name("spmv_csr", "cuda") == "torch.segment"
    assert reg.default_name("spmv_ell", "cuda") == "cuda.ell"
    assert reg.default_name("spmv_ell", "cpu") == "torch.ell"
    assert reg.default_name("spmm_csr", "cuda") == "cuda.bcsr"
    assert reg.default_name("spmm_csr", "cpu") == "torch.segment"
    assert reg.default_name("moe_ffn", "cuda") == "cuda.gmm"
    assert reg.default_name("moe_ffn", "cpu") == "torch.capacity"
    bcsr = reg.get("spmv_csr", "cuda.bcsr")
    assert bcsr.platforms == ("cuda",) and bcsr.fuse_epilogue
    assert [(c.repack, c.src, c.dst) for c in bcsr.marshal] == \
        [("bcsr_pack128", "csr_binding", "BCSR128x128")]
    assert [(c.repack, c.src, c.dst)
            for c in reg.get("spmm_csr", "cuda.bcsr").marshal] == \
        [("bcsr_pack_mm128", "csr_binding_mm", "BCSR128x128")]
    host = reg.get("spmv_csr", "cuda.ell")
    assert host.platforms == ("cuda",) and not host.jit_safe
    assert host.fuse_epilogue
    assert [(c.repack, c.src, c.dst) for c in host.marshal] == \
        [("ell_pack128", "csr_binding", "ELL128")]
    assert reg.candidates("spmv_csr", "CSR", "cpu", "host")[-1].name \
        == "torch.dense"


def test_spec_compiler_refuses_what_it_cannot_serve():
    with pytest.raises(lilac.SpecError, match="unknown repack"):
        lilac.register_spec("""
HARNESS t.bad implements spmv_csr
  marshal x = no_such_pack(a);
""", {"t.bad": lambda b, c, x: None}, registry=lilac.HarnessRegistry())
    with pytest.raises(lilac.SpecError, match="not supported"):
        lilac.register_spec("""
HARNESS t.hooked implements spmv_csr
  BeforeFirstExecution setup;
""", {"t.hooked": lambda b, c: None}, registry=lilac.HarnessRegistry())
    with pytest.raises(lilac.SpecError, match="tune clauses"):
        lilac.register_spec("""
HARNESS t.tuned implements spmv_csr
  tune rows_per_slab in {32, 8};
""", {"t.tuned": lambda b, c: None}, registry=lilac.HarnessRegistry())
    with pytest.raises(lilac.SpecError, match="no kernel body"):
        lilac.register_spec("HARNESS t.nobody implements spmv_csr", {},
                            registry=lilac.HarnessRegistry())
