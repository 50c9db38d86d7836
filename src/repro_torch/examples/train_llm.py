"""End-to-end LM training driver on synthetic data, the twin of
`examples/train_llm.py`: it runs `repro_torch.launch.train.main`, on the
card unless `--device cpu`:

    PYTHONPATH=src python -m repro_torch.examples.train_llm \\
        --arch starcoder2-3b --smoke --steps 100 --batch 8 --seq 128 \\
        [--device cpu]

The train step accumulates gradients, clips them and skips a non-finite
step on the device (`launch/steps.make_train_step`); AdamW (or the
optimizer the arch's size calls for); atomic checkpoints on a writer
thread; a preemption handler; resumable deterministic data. Stop a run
with Ctrl-C, then run it again with --resume: training continues from
the checkpoint, replaying no data.
"""

from repro_torch.launch.train import main

if __name__ == "__main__":
    main()
