"""Conversation prompt templates (LLaVA-lineage, mostly legacy).

The reference ships these for backward compatibility
(its ``hicom/conversation.py``) even though train/infer use HF
``tokenizer.apply_chat_template``; we keep the same template surface so prompts
built through either path are identical.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    PLAIN = auto()
    LLAMA2 = auto()
    QWEN = auto()


@dataclasses.dataclass
class Conversation:
    """Conversation history + prompt rendering."""

    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = None
    version: str = "Unknown"
    modality: str = "image"

    def get_prompt(self) -> str:
        messages = [list(m) for m in self.messages]
        modality_token = f"<{self.modality}>"
        if messages and isinstance(messages[0][1], tuple):
            init_role, init_msg = messages[0]
            text = init_msg[0].replace(modality_token, "").strip()
            if "mmtag" in self.version:
                messages[0] = [init_role, text]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [init_role, f"{modality_token}\n{text}"]

        def text_of(message):
            return message[0] if isinstance(message, tuple) else message

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                ret += f"{role}: {text_of(message)}{self.sep}" if message else f"{role}:"
            return ret
        if style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                ret += f"{role}: {text_of(message)}{seps[i % 2]}" if message else f"{role}:"
            return ret
        if style == SeparatorStyle.LLAMA2:
            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message and role == self.roles[0]
                if not message:
                    continue
                msg = text_of(message)
                if i == 0:
                    msg = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" + msg
                if i % 2 == 0:
                    ret += f"{self.sep}[INST] {msg} [/INST]"
                else:
                    ret += f" {msg} {self.sep2}"
            return ret.lstrip(self.sep)
        if style == SeparatorStyle.QWEN:
            ret = self.system + self.sep + "\n"
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message and role == self.roles[0]
                ret += f"{role}{text_of(message)}{self.sep}\n" if message else role
            return ret
        if style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                ret += f"{role}{text_of(message)}{seps[i % 2]}" if message else role
            return ret
        raise ValueError(f"Invalid style: {style}")

    def append_message(self, role, message):
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[list(m) for m in self.messages],
            offset=self.offset, sep_style=self.sep_style,
            sep=self.sep, sep2=self.sep2, version=self.version, modality=self.modality,
        )

    def dict(self):
        return {
            "system": self.system, "roles": self.roles,
            "messages": [[r, m[0] if isinstance(m, tuple) else m] for r, m in self.messages],
            "offset": self.offset, "sep": self.sep, "sep2": self.sep2,
        }


conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    # one-shot example baked into the template (reference conversation.py:322-343)
    messages=[
        ("Human", "What are the key differences between renewable and non-renewable energy sources?"),
        ("Assistant",
            "Renewable energy sources are those that can be replenished naturally in a relatively "
            "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
            "Non-renewable energy sources, on the other hand, are finite and will eventually be "
            "depleted, such as coal, oil, and natural gas. Here are some key differences between "
            "renewable and non-renewable energy sources:\n"
            "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
            "energy sources are finite and will eventually run out.\n"
            "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
            "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
            "and other negative effects.\n"
            "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
            "have lower operational costs than non-renewable sources.\n"
            "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
            "locations than non-renewable sources.\n"
            "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
            "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
            "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
            "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"),
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE, sep="###",
)

conv_llava_plain = Conversation(
    system="", roles=("", ""), messages=[], offset=0,
    sep_style=SeparatorStyle.PLAIN, sep="", sep2="\n",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"), messages=[], offset=0,
    sep_style=SeparatorStyle.SINGLE, sep="###",
)

conv_llava_v0_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("Human", "Assistant"), messages=[], offset=0,
    sep_style=SeparatorStyle.SINGLE, sep="###", version="v0_mmtag",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"), version="v1", messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"), version="v1", messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
)

conv_llava_v1_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"), messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1_mmtag",
)

conv_llava_llama2 = Conversation(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"), version="llama2", messages=[], offset=0,
    sep_style=SeparatorStyle.LLAMA2, sep="<s>", sep2="</s>",
)

conv_llama2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"), version="llama2", messages=[], offset=0,
    sep_style=SeparatorStyle.LLAMA2, sep="<s>", sep2="</s>",
)

conv_mistral = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"), version="llama2", messages=[], offset=0,
    sep_style=SeparatorStyle.LLAMA2, sep="", sep2="</s>",
)

conv_qwen = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), messages=[], offset=0,
    sep_style=SeparatorStyle.QWEN, sep="<|im_end|>", version="qwen",
)

conv_qwen_plain = Conversation(
    system="", roles=("<|im_start|>user\n", "<|im_start|>assistant\n"), messages=[], offset=0,
    sep_style=SeparatorStyle.PLAIN, sep="<|im_end|>", sep2="<|im_end|>", version="qwen_plain",
)

default_conversation = conv_mistral
conv_templates = {
    "default": conv_vicuna_v0,
    "plain": conv_llava_plain,
    "v0": conv_vicuna_v0,
    "v0_plain": conv_llava_plain,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v0": conv_llava_v0,
    "v1": conv_vicuna_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_v1": conv_llava_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_llama2": conv_llava_llama2,
    "llama2": conv_llama2,
    "mistral": conv_mistral,
    "qwen": conv_qwen,
    "qwen_plain": conv_qwen_plain,
}
