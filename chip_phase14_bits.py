"""Phase 14's CPU float32 step, computed the two ways `chip_smoke.py` has
had: as the float32 card-vs-CPU check computed its own (``make_train_step``
with a `GradRecorder`) and as `chip_smoke.cpu_f32_step` computes the one
step both the float32 and the bfloat16 checks now share (`step_readings`).
Prints, per model of `chip_smoke.TRAIN_MODELS`, whether the loss, every
gradient and the running statistics are the same bits, and the seconds.

    python3 chip_phase14_bits.py      # one card (chip_smoke needs CUDA)
"""
import json
import time

import torch

import chip_smoke as cs

rows = []
for name in cs.TRAIN_MODELS:
    t0 = time.perf_counter()
    model = cs.create_model(name, max_disp=cs.MAX_DISP,
                            generator=torch.Generator().manual_seed(0))
    cpu = cs.create_model(name, max_disp=cs.MAX_DISP, device="cpu")
    cpu.load_state_dict(model.state_dict())
    rec = cs.GradRecorder()
    _, loss = cs.make_train_step(cpu, cs.train_config(name))(
        cs.TrainState(cpu, rec), cs.to_device(cs.check_batch(), "cpu"))
    old = (loss.item(), rec.grads, cs.bn_buffers(cpu))
    new, _ = cs.cpu_f32_step(name, model)
    same = (old[0] == new["loss"]
            and len(old[1]) == len(new["grads"])
            and all(torch.equal(a, b) for a, b in zip(old[1], new["grads"]))
            and old[2].keys() == new["stats"].keys()
            and all(torch.equal(old[2][k], new["stats"][k]) for k in old[2]))
    rows.append({"model": name, "loss_old": old[0], "loss_new": new["loss"],
                 "same_bits": same, "grads": len(old[1]),
                 "s": time.perf_counter() - t0})
    print(json.dumps(rows[-1]), flush=True)
print(json.dumps({"phase14_bits": rows,
                  "device": torch.cuda.get_device_name(0)}))
