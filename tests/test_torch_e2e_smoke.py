"""The port's end-to-end example (examples/e2e_smoke_torch.py, the
counterpart of examples/e2e_smoke.py) runs its every stage on the CPU:
sample, determinism, make_video, the GIF round trip and the loss, ending
with "E2E: ALL PASS"."""

import importlib.util
from pathlib import Path

from phenaki_tpu_torch.text import t5

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "e2e_smoke_torch.py"


def test_e2e_example_passes_on_the_cpu(capsys):
    # the offline encoder the example's texts fall back to, without the HF import
    t5._ENCODERS.setdefault((t5.DEFAULT_T5_NAME, 768, "cpu"), t5.HashTextEncoder(768))
    spec = importlib.util.spec_from_file_location("e2e_smoke_torch", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for what in ("sample ok", "determinism ok", "make_video ok (1, 17, 64, 64, 3)", "gif roundtrip ok", "loss ok"):
        assert what in out, what
    assert out.strip().splitlines()[-1] == "E2E: ALL PASS"
