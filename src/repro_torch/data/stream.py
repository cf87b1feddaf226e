"""Synthetic 5-task query stream mirroring the paper's benchmark mix.

500 instances per dataset family (MMLU / HellaSwag / Winogrande / GSM8K /
CNN-DailyMail), shuffled into a T=2,500 stream with a fixed seed (paper
§6.1.2).  Templates are designed so the three context features carry real
signal: instruction lines differ per task (task classifier), topical
vocabulary differs (semantic clusters), and sentence structure differs
(Flesch complexity — math word problems read easy, news summaries read
hard).
"""
from __future__ import annotations

import random
from typing import List, Optional

from repro_torch.core.types import Query, TaskType

_TOPICS = {
    "science": ["photosynthesis", "entropy", "mitochondria", "quantum field",
                "tectonic plates", "neural synapse", "catalyst", "osmosis"],
    "history": ["the industrial revolution", "the treaty of versailles",
                "the roman senate", "the silk road", "the cold war",
                "the printing press", "the french revolution"],
    "finance": ["compound interest", "market liquidity", "federal reserve",
                "inflation target", "sovereign bond", "hedge fund",
                "quarterly earnings", "exchange rate"],
}

_QA_TMPL = (
    "Answer the following multiple choice question.\n"
    "Question: Which statement about {topic} is correct?\n"
    "A) {topic} only occurs in {noun}.\nB) {topic} is unrelated to {noun2}.\n"
    "C) {topic} fundamentally involves {noun2}.\nD) none of the above.\n"
    "Answer:")
_HELLA_TMPL = (
    "Choose the most plausible continuation.\n"
    "Context: A person studying {topic} opened their notes and {verb}.\n"
    "Options: 1) {cont1} 2) {cont2} 3) {cont3} 4) {cont4}\nBest option:")
_WINO_TMPL = (
    "Resolve the pronoun in the sentence.\n"
    "Sentence: The teacher explained {topic} to the student because _ "
    "prepared a lesson about {noun}.\nWho does the blank refer to?")
_GSM_TMPL = (
    "Solve the math word problem step by step.\n"
    "Problem: Sam buys {a} pens for {b} dollars each and {c} notebooks for "
    "{d} dollars each. He pays with a {e} dollar bill. How much change does "
    "Sam get back?\nAnswer:")
_SUMM_TMPL = (
    "Summarize the following article in three sentences.\n"
    "Article: Authorities announced on {day} that the committee overseeing "
    "{topic} had concluded its preliminary investigation into {noun}, "
    "citing considerable uncertainty surrounding implementation timelines; "
    "nevertheless, representatives emphasised that infrastructure "
    "modernisation, regulatory harmonisation, and institutional "
    "accountability remain indispensable prerequisites. {filler}\nSummary:")

_NOUNS = ["plants", "markets", "archives", "laboratories", "parliaments",
          "networks", "institutions", "reactors"]
_VERBS = ["began reviewing the diagrams", "recited the definitions",
          "sketched the process", "quizzed a classmate"]
_CONTS = ["they summarized each section aloud",
          "the notebook transformed into a bird",
          "they rehearsed the key formulas",
          "the desk started a conversation"]
_DAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday"]
_FILLER = ("Observers characterised the deliberations as unprecedented, "
           "noting that comprehensive documentation would be disseminated "
           "to stakeholders following additional consultation.")


def make_query(uid: int, task: TaskType, rng: random.Random) -> Query:
    domain = rng.choice(list(_TOPICS))
    topic = rng.choice(_TOPICS[domain])
    noun = rng.choice(_NOUNS)
    noun2 = rng.choice([n for n in _NOUNS if n != noun])
    if task == TaskType.QA:
        text = _QA_TMPL.format(topic=topic, noun=noun, noun2=noun2)
        ref = "C"
    elif task == TaskType.COMPLETION:
        conts = rng.sample(_CONTS, 4)
        text = _HELLA_TMPL.format(topic=topic, verb=rng.choice(_VERBS),
                                  cont1=conts[0], cont2=conts[1],
                                  cont3=conts[2], cont4=conts[3])
        ref = "1"
    elif task == TaskType.REASONING:
        text = _WINO_TMPL.format(topic=topic, noun=noun)
        ref = "the teacher"
    elif task == TaskType.MATH:
        a, b, c, d = (rng.randint(2, 9) for _ in range(4))
        total = a * b + c * d
        e = ((total // 10) + 1) * 10
        text = _GSM_TMPL.format(a=a, b=b, c=c, d=d, e=e)
        ref = str(e - total)
    else:
        text = _SUMM_TMPL.format(day=rng.choice(_DAYS), topic=topic,
                                 noun=noun, filler=_FILLER)
        ref = f"The committee on {topic} concluded its investigation."
    max_new = {TaskType.QA: 8, TaskType.COMPLETION: 8, TaskType.REASONING: 4,
               TaskType.MATH: 96, TaskType.SUMMARIZATION: 128}[task]
    return Query(uid=uid, text=text, task=task, reference=ref,
                 max_new_tokens=max_new)


def make_stream(per_task: int = 500, seed: int = 0,
                tasks: Optional[List[TaskType]] = None) -> List[Query]:
    """The paper's evaluation stream: per_task instances of each family,
    shuffled with a fixed seed (T = 5 × per_task = 2,500 by default)."""
    rng = random.Random(seed)
    tasks = tasks or list(TaskType)
    queries: List[Query] = []
    uid = 0
    for task in tasks:
        for _ in range(per_task):
            queries.append(make_query(uid, task, rng))
            uid += 1
    rng.shuffle(queries)
    return queries


def labeled_sample(n_per_task: int = 40, seed: int = 1):
    """Small labeled sample for the task classifier's offline fit (§4.2.1:
    'we sample a small portion of our evaluation dataset')."""
    rng = random.Random(seed)
    texts, labels = [], []
    uid = 0
    for task in TaskType:
        for _ in range(n_per_task):
            texts.append(make_query(uid, task, rng).text)
            labels.append(int(task))
            uid += 1
    return texts, labels
