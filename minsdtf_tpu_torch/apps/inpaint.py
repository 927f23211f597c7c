"""Gradio inpaint demo over the port's pipeline on the card (counterpart of the
reference ``inpaint.py``)."""

from __future__ import annotations

import numpy as np

from minsdtf_tpu_torch.apps import common


def main():
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise SystemExit("gradio is not installed in this environment") from e

    pipe = common.build_pipeline()

    def generate(image, mask, prompt, negative, steps, scale, rescale, strength, blur, seed):
        images = pipe.inpaint(
            prompt, negative_prompt=negative or None, num_steps=int(steps),
            unconditional_guidance_scale=float(scale), guidance_rescale=float(rescale),
            reference_image=np.asarray(image), reference_image_strength=float(strength),
            inpaint_mask=np.asarray(mask), mask_blur_strength=int(blur), seed=int(seed),
        )
        common.save_outputs(images, prompt)
        return [img for img in images]

    demo = gr.Interface(
        fn=generate,
        inputs=[
            gr.Image(label="Reference image"),
            gr.Image(label="Mask (white = regenerate)", image_mode="L"),
            gr.Textbox(label="Prompt"),
            gr.Textbox(label="Negative prompt"),
            gr.Slider(1, 100, value=25, step=1, label="Steps"),
            gr.Slider(0, 20, value=7.5, label="Guidance scale"),
            gr.Slider(0, 1, value=0.7, label="Guidance rescale"),
            gr.Slider(0, 1, value=0.8, label="Strength"),
            gr.Slider(1, 33, value=5, step=2, label="Mask blur"),
            gr.Number(value=int(np.random.randint(0, 2**31 - 1)), label="Seed"),
        ],
        outputs=gr.Gallery(label="Images"),
        title="minsdtf-tpu (PyTorch) inpaint",
    )
    demo.launch()


if __name__ == "__main__":
    main()
