"""The reference's example programs (``examples/``) on the port, one module
each, every one a ``main(argv)`` and a ``run(...)`` that returns its
losses and timings:

  * ``open_llama_4d_benchmark`` and ``llama_mfu_calculator`` — OpenLLaMA's
    train-step MFU benchmark;
  * ``llama2_4d_finetune`` — Llama-2 over ("dp", "tp") with ZeRO-2, grad
    clip and a checkpoint, and its loss parity against one device;
  * ``nanogpt_4d_finetune`` — nanoGPT over ("dp", "tp"), with and without
    ZeRO-2, and its loss parity;
  * ``mixtral_4d_benchmark`` — Mixtral expert parallel over ("dp", "ep");
  * ``resilient_train`` — crash and resume through ``CheckpointManager``
    with dynamic loss scaling;
  * ``fp8_train`` — the delayed-scaling fp8 Llama;
  * ``autosplit_pipeline`` — a tangled model cut by ``pipe.split_graph``
    and trained through ``PipeEngine``.

Each runs on the card unless ``--cpu`` is given; a mesh of several ranks
runs under ``torchrun`` (``_common.launch``).
"""
