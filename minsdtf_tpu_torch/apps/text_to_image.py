"""Gradio txt2img demo over the port's pipeline on the card (counterpart of the
reference ``text_to_image.py``)."""

from __future__ import annotations

import numpy as np

from minsdtf_tpu_torch.apps import common


def main():
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise SystemExit("gradio is not installed in this environment") from e

    pipe = common.build_pipeline()

    def generate(prompt, negative, steps, scale, rescale, seed, batch):
        images = pipe.text_to_image(
            prompt, negative_prompt=negative or None, batch_size=int(batch),
            num_steps=int(steps), unconditional_guidance_scale=float(scale),
            guidance_rescale=float(rescale), seed=int(seed),
        )
        common.save_outputs(images, prompt)
        return [img for img in images]

    demo = gr.Interface(
        fn=generate,
        inputs=[
            gr.Textbox(label="Prompt"),
            gr.Textbox(label="Negative prompt"),
            gr.Slider(1, 100, value=25, step=1, label="Steps"),
            gr.Slider(0, 20, value=7.5, label="Guidance scale"),
            gr.Slider(0, 1, value=0.7, label="Guidance rescale"),
            gr.Number(value=int(np.random.randint(0, 2**31 - 1)), label="Seed"),
            gr.Slider(1, 8, value=1, step=1, label="Batch"),
        ],
        outputs=gr.Gallery(label="Images"),
        title="minsdtf-tpu (PyTorch) txt2img",
    )
    demo.launch()


if __name__ == "__main__":
    main()
